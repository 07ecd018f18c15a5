"""The port's GeoTr (``dvd_tpu_torch/models/geotr.py``) against
``dvd_tpu/models/geotr.py`` on the CPU in f32: the sine embedding bit for
bit, the convex upsampling and one ``AttnLayer``, then ``GeoTr``,
``GeoTrSegInf``, ``GeoTrSeg`` and ``GeoTrSegWoMask`` at a 64^2 perception
size (64 tokens), each within 2e-4 of max|ref| (the aux nets' bar).

The whole networks' weights come the way a user's do: a state_dict in
the reference checkpoint's layout (``seg.pth``'s names: packed
``in_proj_*``, ``multihead_attn_list``, ``norm2_list``, RAFT's
``layerN.M`` and ``flow_head.convN``, BN ``running_*``) converted by the
port's ``GEOTR_SEG_RULES`` into flax variables, which both packages load,
nothing skipped.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.models import geotr as jgeotr
from dvd_tpu_torch.models import geotr, layers
from dvd_tpu_torch.training import convert as C
from test_torch_common import (mask_margin_shift, nchw, np_tree, port,
                               random_variables, t)

PER = 64


def _close(got, want, rel=2e-4):
    want = np.asarray(want)
    bar = rel * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar, f"max err {err:.3e} > {bar:.3e}"


def test_sine_position_embedding_is_dvd_tpus():
    for h, w, f in ((36, 36, 128), (8, 8, 128), (5, 7, 16)):
        np.testing.assert_array_equal(geotr.sine_position_embedding(h, w, f),
                                      jgeotr.sine_position_embedding(h, w, f))


def test_convex_upsample_flow():
    rng = np.random.RandomState(0)
    flow = rng.randn(2, 5, 6, 2).astype(np.float32)
    mask = rng.randn(2, 5, 6, 576).astype(np.float32)
    want = jgeotr.convex_upsample_flow(jnp.asarray(flow), jnp.asarray(mask))
    got = geotr.convex_upsample_flow(t(flow), nchw(mask))
    assert got.shape == (2, 40, 48, 2)
    _close(got.numpy(), want, 1e-5)


def test_attn_layer():
    rng = np.random.RandomState(1)
    tgt, mem = (rng.randn(2, n, 32).astype(np.float32) for n in (12, 20))
    pos, mpos = (rng.randn(1, n, 32).astype(np.float32) for n in (12, 20))
    mod = jgeotr.AttnLayer(32, 4, 64)
    v = random_variables(mod, *(jnp.asarray(a) for a in (tgt, mem, pos, mpos)))
    want = mod.apply(v, *(jnp.asarray(a) for a in (tgt, mem, pos, mpos)))
    with torch.no_grad():
        got = port(geotr.AttnLayer(32, 4, 64), v)(t(tgt), t(mem), t(pos),
                                                  t(mpos))
    _close(got.numpy(), want, 1e-5)


# the reference seg.pth's names for the port's (GEOTR_SEG_RULES inverted)
_REF = ((r"\bfnet\.layer(\d)_(\d)\.", r"fnet.layer\1.\2."),
        (r"\bdownsample_0\.", "downsample.0."),
        (r"\blayers_(\d+)\.", r"layers.\1."),
        (r"\bmultihead_attn_0\.", "multihead_attn_list.0."),
        (r"\bnorm2_0\.", "norm2_list.0."),
        (r"\bflow_head_conv(\d)\.", r"flow_head.conv\1."),
        (r"\bmask_(\d)\.", r"mask.\1."),
        (r"GeoTr\.TransDecoder\.query_embed$", "GeoTr.query_embed.weight"))
_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def reference_state_dict(module: torch.nn.Module) -> dict:
    """``module``'s state_dict under the reference checkpoint's names, the
    attention projections packed as ``nn.MultiheadAttention``'s, plus the
    keys the rules drop (the second cross-attention, BN batch counts)."""
    out, packed = {}, {}
    for k, v in module.state_dict().items():
        for pat, rep in _REF:
            k = re.sub(pat, rep, k)
        path, _, leaf = k.rpartition(".")
        k = f"{path}.{_LEAF.get(leaf, leaf)}"
        m = re.match(r"(.*)\.([qkv])_proj\.(weight|bias)$", k)
        if m:
            packed.setdefault((m.group(1), m.group(3)), {})[m.group(2)] = v
        else:
            out[k] = v.numpy()
    for (prefix, leaf), parts in packed.items():
        w = torch.cat([parts[c] for c in "qkv"]).numpy()
        out[f"{prefix}.in_proj_{leaf}"] = w
        if ".multihead_attn_list.0" in prefix:   # the dead second one
            out[f"{prefix[:-1]}1.in_proj_{leaf}"] = w
    out["msk.stage1.rebnconvin.bn_s1.num_batches_tracked"] = np.array(5)
    return out


MODELS = {
    # name -> (dvd_tpu module, port module)
    "GeoTr": (lambda: jgeotr.GeoTr(6, 256),
              lambda: geotr.GeoTr(image_size=PER)),
    "GeoTrSegInf": (lambda: jgeotr.GeoTrSegInf(mask_size=96),
                    lambda: geotr.GeoTrSegInf(96, full=True, image_size=PER)),
    "GeoTrSeg": (lambda: jgeotr.GeoTrSeg(mask_size=96),
                 lambda: geotr.GeoTrSeg(96, image_size=PER)),
    "GeoTrSegWoMask": (lambda: jgeotr.GeoTrSegWoMask(),
                       lambda: geotr.GeoTrSegWoMask(image_size=PER)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_geotr_networks_match_dvd_tpu(name):
    make_j, make_p = MODELS[name]
    x = np.random.RandomState(2).rand(2, PER, PER, 3).astype(np.float32)
    src = layers.seeded_init_(make_p(), torch.Generator().manual_seed(3))
    if hasattr(src, "msk"):
        # the soft mask clear of GeoTrSeg's hard 0.5 threshold
        with torch.no_grad():
            d0 = src.msk(nchw(x))[0].permute(0, 2, 3, 1).numpy()
            src.msk.outconv.bias += mask_margin_shift(d0)
    variables = C.convert_state_dict(reference_state_dict(src),
                                     C.GEOTR_SEG_RULES)
    net = port(make_p(), variables)
    report = C.variables_to_state_dict(variables, net)[1]
    assert report == ([], [], [])                     # nothing skipped
    mod = make_j()
    want = mod.apply(np_tree(variables), jnp.asarray(x))
    with torch.no_grad():
        got = net(nchw(x))
    if name == "GeoTr":
        want, got = (want,), (got,)
    bm = np.asarray(want[0])
    assert bm.shape == (2, PER, PER, 2) and np.abs(bm).max() > 1.0
    _close(got[0].numpy(), bm)
    if name in ("GeoTrSegInf", "GeoTrSeg"):
        assert got[1].shape == (2, 1, 96, 96)
        _close(got[1].permute(0, 2, 3, 1).numpy(), want[1])
        if name == "GeoTrSeg":
            hard = np.unique(np.asarray(want[1]))
            assert set(hard.tolist()) <= {0.0, 1.0}
    elif name == "GeoTrSegWoMask":
        assert got[1] is None and want[1] is None


def test_mask_branch_reference_file_skips_geotr():
    """The shipped (mask-only) GeoTrSegInf loads a whole seg.pth: its
    GeoTr subtree is skipped and reported, the mask branch loaded."""
    full = layers.seeded_init_(geotr.GeoTrSegInf(64, True, PER),
                               torch.Generator().manual_seed(5))
    variables = C.convert_state_dict(reference_state_dict(full),
                                     C.GEOTR_SEG_RULES)
    net = geotr.GeoTrSegInf(64)
    sd, report = C.variables_to_state_dict(variables, net)
    assert not report.missing and not report.unexpected
    assert report.skipped and all(k.startswith("GeoTr.")
                                  for k in report.skipped)
    net.load_state_dict(sd)
    for k, v in net.state_dict().items():
        assert torch.equal(v, full.state_dict()[k]), k
    with pytest.raises(ValueError, match="missing"):
        C.load_variables(geotr.GeoTrSegInf(64, True, PER),
                         {"params": {"msk": variables["params"]["msk"]},
                          "batch_stats": variables["batch_stats"]})
