"""The port's copy of the torch -> flax converter
(``dvd_tpu_torch/training/convert.py``, ``cli/convert_ckpt.py``) against
``dvd_tpu``'s on the same reference-layout state_dicts: identical trees,
leaf for leaf, for every rule set, and the same ``.msgpack`` files.

The reference checkpoints' modules are not importable here, so each
state_dict is the port module's, renamed to the reference's layout (the
names ``dvd_tpu``'s rules expect), plus hand-written keys that exercise
every GeoTr and VGG16 rule (dropped, renamed, packed attention)."""

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.cli import convert_ckpt as jcli
from dvd_tpu.training import checkpoint as jckpt
from dvd_tpu.training import convert as J
from dvd_tpu_torch.cli import convert_ckpt as cli
from dvd_tpu_torch.models import dit, geotr, layers, textline_unet, u2net
from dvd_tpu_torch.training import checkpoint as ckpt
from dvd_tpu_torch.training import convert as C
from test_torch_common import MINI_DIT
from test_torch_models import (_dit_ref_key, _line_ref_key,
                               _reference_state_dict)


def _geotr_extra(rng):
    """GeoTr transformer / RAFT keys of the reference's seg.pth (after the
    'module.' strip), small shapes: every GEOTR_SEG_RULES rule fires."""
    r = lambda *s: rng.randn(*s).astype(np.float32)
    d = "GeoTr.TransDecoder.layers.0."
    return {
        "GeoTr.query_embed.weight": r(4, 8),
        "query_embed.weight": r(4, 8),
        d + "multihead_attn_list.0.in_proj_weight": r(24, 8),
        d + "multihead_attn_list.0.in_proj_bias": r(24),
        d + "multihead_attn_list.0.out_proj.weight": r(8, 8),
        d + "multihead_attn_list.1.in_proj_weight": r(24, 8),
        d + "norm2_list.0.weight": r(8),
        d + "norm2_list.1.bias": r(8),
        d + "dropout1.weight": r(8),
        "GeoTr.fnet.layer1.0.conv1.weight": r(8, 4, 3, 3),
        "GeoTr.fnet.layer2.1.norm1.running_mean": r(8),
        "GeoTr.fnet.layer2.1.norm1.running_var": r(8),
        "GeoTr.fnet.layer2.1.norm1.num_batches_tracked": np.array(3),
        "GeoTr.fnet.layer2.0.downsample.0.weight": r(8, 4, 1, 1),
        "GeoTr.fnet.layer2.0.downsample.1.weight": r(8),
        "GeoTr.update_block.flow_head.conv1.weight": r(8, 8, 3, 3),
        "GeoTr.update_block.flow_head.conv2.bias": r(2),
        "GeoTr.update_block.mask.0.weight": r(8, 8, 3, 3),
        "GeoTr.update_block.mask.2.bias": r(9),
        "GeoTr.pos_embed": r(1, 4, 8),
    }


def _vgg16(rng):
    """torchvision vgg16's key layout, small shapes: the levels used,
    the levels past /8 and the classifier (dropped)."""
    sd = {}
    for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28):
        sd[f"features.{i}.weight"] = rng.randn(4, 3, 3, 3).astype(np.float32)
        sd[f"features.{i}.bias"] = rng.randn(4).astype(np.float32)
    for i in (0, 3, 6):
        sd[f"classifier.{i}.weight"] = rng.randn(5, 6).astype(np.float32)
    return sd


def reference_state_dict(family: str):
    g = torch.Generator().manual_seed(4)
    rng = np.random.RandomState(4)
    if family == "dit":
        sd = layers.seeded_init_(dit.DiT(**MINI_DIT), g).state_dict()
        return _reference_state_dict(sd, _dit_ref_key), C.DIT_RULES
    if family == "u2netp":
        sd = layers.seeded_init_(u2net.Seg(64), g).state_dict()
        return _reference_state_dict(sd, lambda k: k), C.U2NETP_RULES
    if family == "line":
        sd = layers.seeded_init_(textline_unet.TextLineUNet(), g).state_dict()
        return _reference_state_dict(sd, _line_ref_key), C.LINE_UNET_RULES
    if family == "geotr_seg":
        sd = layers.seeded_init_(geotr.GeoTrSegInf(64), g).state_dict()
        out = _reference_state_dict(sd, lambda k: k)
        out.update(_geotr_extra(rng))
        return out, C.GEOTR_SEG_RULES
    return _vgg16(rng), C.VGG16_RULES


def assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(set(got) ^ set(want))[:6])
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("family", ["dit", "u2netp", "line", "geotr_seg",
                                    "vgg16"])
def test_convert_state_dict_matches_dvd_tpu(family):
    sd, rules = reference_state_dict(family)
    assert rules == getattr(J, {"dit": "DIT_RULES", "u2netp": "U2NETP_RULES",
                                "line": "LINE_UNET_RULES",
                                "geotr_seg": "GEOTR_SEG_RULES",
                                "vgg16": "VGG16_RULES"}[family])
    want = J.convert_state_dict(sd, rules)
    got = C.convert_state_dict(sd, rules)
    assert_same_tree(got, want)
    if family == "geotr_seg":
        # the rules fired: packed attention split, dead copies dropped
        att = got["params"]["GeoTr"]["TransDecoder"]["layers_0"]
        assert set(att["multihead_attn_0"]) == {"q_proj", "k_proj", "v_proj",
                                                "out_proj"}
        assert "norm2_1" not in att and "dropout1" not in att
    for ref_vars in (got, J.convert_state_dict(sd, rules[:1])):
        for coll in ("params", "batch_stats"):
            assert C.validate_against(got, ref_vars, coll) == \
                J.validate_against(got, ref_vars, coll)


@pytest.mark.parametrize("kw", [{}, {"strip_prefix": 7},
                                {"sub_key": "model"}])
def test_load_torch_state_dict_matches_dvd_tpu(tmp_path, kw):
    sd = {("module." if kw.get("strip_prefix") else "") + k: torch.randn(3, 2)
          for k in ("a.weight", "b.bias")}
    sd["n.num_batches_tracked"] = torch.tensor(5)
    path = tmp_path / "ckpt.pth"
    torch.save({"model": sd, "opt": {}} if kw.get("sub_key") else sd, path)
    want = J.load_torch_state_dict(str(path), **kw)
    got = C.load_torch_state_dict(str(path), **kw)
    assert_same_tree(got, want)


@pytest.mark.parametrize("kind,family", [("line", "line"),
                                         ("seg_model", "u2netp")])
def test_convert_cli_writes_dvd_tpus_file(tmp_path, kind, family):
    """The port's CLI (validated against the port's module) and dvd_tpu's
    write files that either package reads as the same tree."""
    sd, _ = reference_state_dict(family)
    src = tmp_path / "ref.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               src)
    cli.main(["--kind", kind, "--src", str(src),
              "--dst", str(tmp_path / "port.msgpack"), "--validate"])
    jcli.convert(kind, str(src), str(tmp_path / "jax.msgpack"))
    for name in ("port", "jax"):
        path = str(tmp_path / f"{name}.msgpack")
        assert_same_tree(ckpt.load_variables(path),
                         jckpt.load_variables(str(tmp_path / "jax.msgpack")))
        assert_same_tree(jckpt.load_variables(path),
                         jckpt.load_variables(str(tmp_path / "port.msgpack")))


def test_convert_cli_validate_refuses(tmp_path):
    """--validate raises on a tree that does not fit the port's module:
    an unexpected leaf (line), and leaves of the wrong shapes (the small
    vgg16 layout, against the port's VGG16Pyramid); nothing is written."""
    sd, _ = reference_state_dict("line")
    sd["outc.conv.extra.weight"] = np.zeros((2, 2), np.float32)
    src = tmp_path / "ref.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               src)
    with pytest.raises(ValueError, match="unexpected"):
        cli.convert("line", str(src), str(tmp_path / "x.msgpack"),
                    validate=True)
    vsd, _ = reference_state_dict("vgg16")
    torch.save({k: torch.from_numpy(v) for k, v in vsd.items()},
               tmp_path / "vgg.pth")
    with pytest.raises(ValueError, match="shape"):
        cli.convert("vgg", str(tmp_path / "vgg.pth"),
                    str(tmp_path / "v.msgpack"), validate=True)
    assert not (tmp_path / "x.msgpack").exists()
    assert not (tmp_path / "v.msgpack").exists()
