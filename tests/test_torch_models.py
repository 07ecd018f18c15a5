"""``dvd_tpu_torch`` models against their ``dvd_tpu`` flax counterparts at
f32 on the CPU, with the flax variables carried across by the weight
bridge; and the bridge itself against ``dvd_tpu/training/convert.py``.

Zero leaves of the DiT's variables are filled with seeded N(0, 0.02^2),
so its adaLN gates and final layer (zero at init) carry signal.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvd_tpu.models import dit as jdit
from dvd_tpu.models import geotr as jgeotr
from dvd_tpu.models import layers as jlayers
from dvd_tpu.models import satrn as jsatrn
from dvd_tpu.models import textline_unet as jline
from dvd_tpu.models import u2net as ju2net
from dvd_tpu.training import convert as jconvert
from dvd_tpu_torch.models import dit, geotr, layers, satrn, textline_unet, u2net
from dvd_tpu_torch.ops.kernels.conv3x3 import k_major_weights
from dvd_tpu_torch.training.convert import variables_to_state_dict
from test_torch_common import (fill_zero_leaves, mask_margin_shift, nchw,
                               nhwc, np_tree, port, t)

KEY = jax.random.PRNGKey(0)


def _init(mod, *args, **kw):
    return np_tree(mod.init(KEY, *args, **kw))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------- layers
def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_self_attention():
    x = _rand(2, 16, 48)
    mod = jlayers.SelfAttention(48, 3)
    v = fill_zero_leaves(_init(mod, jnp.asarray(x)), 1)
    want = mod.apply(v, jnp.asarray(x))
    got = port(layers.SelfAttention(48, 3), v)(t(x))
    _close(got.detach(), want, 1e-5)


def test_cross_attention():
    q, kv = _rand(2, 16, 48), _rand(2, 20, 48, seed=1)
    mod = jlayers.CrossAttention(48, 3)
    v = fill_zero_leaves(_init(mod, jnp.asarray(q), jnp.asarray(kv),
                               jnp.asarray(kv)), 1)
    want = mod.apply(v, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    got = port(layers.CrossAttention(48, 3), v)(t(q), t(kv), t(kv))
    _close(got.detach(), want, 1e-5)


def test_mlp_and_patch_embed():
    x = _rand(2, 16, 48)
    mod = jlayers.Mlp(192, 48)
    v = fill_zero_leaves(_init(mod, jnp.asarray(x)), 1)
    got = port(layers.Mlp(48, 192, 48), v)(t(x))
    _close(got.detach(), mod.apply(v, jnp.asarray(x)), 1e-5)

    img = _rand(2, 16, 16, 5)
    mod = jlayers.PatchEmbed(2, 48)
    v = fill_zero_leaves(_init(mod, jnp.asarray(img)), 1)
    got = port(layers.PatchEmbed(5, 2, 48), v)(nchw(img))
    _close(got.detach(), mod.apply(v, jnp.asarray(img)), 1e-5)


def test_timestep_embedder_and_tables():
    ts = np.array([0.0, 1.0, 2.0, 333.33, 999.0], np.float32)
    mod = jlayers.TimestepEmbedder(48)
    v = _init(mod, jnp.asarray(ts))
    got = port(layers.TimestepEmbedder(48), v)(t(ts))
    _close(got.detach(), mod.apply(v, jnp.asarray(ts)), 1e-5)
    np.testing.assert_array_equal(layers.get_2d_sincos_pos_embed(48, 8),
                                  jlayers.get_2d_sincos_pos_embed(48, 8))
    np.testing.assert_array_equal(satrn.satrn_sinusoid_table(16, 32),
                                  jsatrn._satrn_sinusoid_table(16, 32))
    x, sh, sc = _rand(2, 7, 48), _rand(2, 48, seed=1), _rand(2, 48, seed=2)
    _close(layers.modulate(layers.layer_norm(t(x)), t(sh), t(sc)),
           jlayers.modulate(jlayers.layer_norm(jnp.asarray(x)),
                            jnp.asarray(sh), jnp.asarray(sc)), 1e-5)


def test_satrn_decoder():
    feat = _rand(2, 4, 4, 32)
    mod = jsatrn.Decoder(n_layers=2, n_head=2, d_k=8, d_v=8, d_model=32,
                         n_position=8, d_inner=64)
    v = fill_zero_leaves(_init(mod, jnp.asarray(feat)), 1)
    want = mod.apply(v, jnp.asarray(feat))
    got = port(satrn.Decoder(2, 2, 8, 8, 32, 8, 64), v)(t(feat))
    _close(got.detach(), want, 1e-4)


# ---------------------------------------------------------------- DiT
MINI = dict(input_size=16, patch_size=2, hidden_size=48, depth=2,
            num_heads=3)


def _dit_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(2, 16, 16, 2).astype(np.float32),
        t=np.array([1000 * 2 / 3, 1000 / 3], np.float32),
        y512=rng.rand(2, 128, 128, 3).astype(np.float32),
        mask_cat=rng.rand(2, 128, 128, 1).astype(np.float32),
        mask_y512=rng.randn(2, 16, 16, 384).astype(np.float32),
        line_msk=rng.randn(2, 16, 16, 64).astype(np.float32),
        init_flow=(rng.randn(2, 16, 16, 2) * 0.1).astype(np.float32),
        init_feat=rng.randn(2, 16, 16, 256).astype(np.float32))


def _jax_dit():
    mod = jdit.DiT(tv=True, chain_blocks=False, **MINI)
    a = {k: jnp.asarray(v) for k, v in _dit_inputs().items()}
    x, tt = a.pop("x"), a.pop("t")
    v = _init(mod, x, tt, remap_timesteps=False, **a)
    return mod, fill_zero_leaves(v, 7)


@pytest.mark.parametrize("seed_init_feat", [False, True])
def test_dit_matches_flax(seed_init_feat):
    mod, v = _jax_dit()
    inp = _dit_inputs(1)
    a = {k: jnp.asarray(x) for k, x in inp.items()}
    want_pred, want_feat = mod.apply(
        v, a.pop("x"), a.pop("t"), seed_init_feat=jnp.full((2,),
                                                           seed_init_feat),
        remap_timesteps=True, **a)
    net = port(dit.DiT(**MINI), v)
    with torch.no_grad():
        pred, feat = net(
            t(inp["x"]), t(inp["t"]), init_flow=t(inp["init_flow"]),
            init_feat=nchw(inp["init_feat"]), y512=nchw(inp["y512"]),
            mask_cat=nchw(inp["mask_cat"]), mask_y512=nchw(inp["mask_y512"]),
            line_msk=nchw(inp["line_msk"]),
            seed_init_feat=torch.full((2,), seed_init_feat),
            remap_timesteps=True)
    _close(nhwc(feat), want_feat, 1e-4, 1e-4)
    assert np.abs(np.asarray(want_pred) - inp["init_flow"]).max() > 1e-2
    _close(pred, want_pred, 1e-4)


# --------------------------------------------------------- aux nets
def test_u2netp_matches_flax():
    x = np.random.RandomState(2).rand(1, 44, 44, 3).astype(np.float32)
    mod = ju2net.U2NetP(1)
    v = _init(mod, jnp.asarray(x))
    want = mod.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(u2net.U2NetP(), v)(nchw(x))
    for g, w in zip(got, want):     # d0 then hx6 .. hx1d (odd ceil pools)
        _close(nhwc(g), w, 2e-4, 1e-4)


def test_seg_and_geotr_mask_branch():
    x = np.random.RandomState(3).rand(1, 44, 44, 3).astype(np.float32)
    mod = ju2net.Seg(mask_size=64)
    v = _init(mod, jnp.asarray(x))
    d0 = np.asarray(mod.apply(v, jnp.asarray(x))[1])
    v["params"]["msk"]["outconv"]["bias"] += mask_margin_shift(d0)
    want = mod.apply(v, jnp.asarray(x))
    assert np.abs(np.asarray(want[1]) - 0.5).min() > 0.05
    with torch.no_grad():
        mskx, d0_up, pyr = port(u2net.Seg(64), v)(nchw(x))
    assert (d0_up - 0.5).abs().min().item() > 0.05
    _close(nhwc(mskx), want[0], 1e-5)
    _close(nhwc(d0_up), want[1], 2e-4)
    for g, w in zip(pyr, want[2:]):
        _close(nhwc(g), w, 2e-4, 1e-4)
    _close(nhwc(u2net.seg_pyramid_to_latent(pyr, 16)),
           ju2net.seg_pyramid_to_latent(want[2:], 16), 2e-4, 1e-4)

    gmod = jgeotr.GeoTrSegInf(mask_size=64)
    gv = _init(gmod, jnp.asarray(np.zeros((1, 64, 64, 3), np.float32)))
    x64 = np.random.RandomState(4).rand(1, 64, 64, 3).astype(np.float32)
    _, want_mask = gmod.apply(gv, jnp.asarray(x64))
    net = geotr.GeoTrSegInf(64)
    sd, report = variables_to_state_dict(gv, net)
    assert not report.missing and not report.unexpected
    assert report.skipped and all(k.startswith("GeoTr.")
                                  for k in report.skipped)
    net.load_state_dict(sd)
    with torch.no_grad():
        bm, mask = net(nchw(x64))
    assert bm is None     # the mask branch alone
    _close(nhwc(mask), want_mask, 2e-4)


def test_textline_unet_matches_flax():
    x = np.random.RandomState(5).rand(1, 32, 32, 3).astype(np.float32)
    mod = jline.TextLineUNet()
    v = _init(mod, jnp.asarray(x))
    want_feat, want_logits = mod.apply(v, jnp.asarray(x))
    with torch.no_grad():
        feat, logits = port(textline_unet.TextLineUNet(), v)(nchw(x))
    _close(nhwc(feat), want_feat, 2e-4, 1e-4)
    _close(nhwc(logits), want_logits, 2e-4, 1e-4)


# ------------------------------------------------------------- bridge
_PYRAMID = {"level_0_conv0": "level_0.0", "level_1_conv0": "level_1.0",
            "level_2_conv0": "level_2.0", "level_2_conv1": "level_2.2",
            "level_3_conv0": "level_3.0", "level_3_conv1": "level_3.2",
            "level_3_conv2": "level_3.4"}
_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
_DOUBLE = {"conv_0": 0, "bn_1": 1, "conv_3": 3, "bn_4": 4}


def _ref_leaf(key):
    path, _, leaf = key.rpartition(".")
    return f"{path}.{_LEAF.get(leaf, leaf)}"


def _dit_ref_key(k):
    k = re.sub(r"\b(blocks|layer_stack)_(\d+)\.", r"\1.\2.", k)
    for new, old in _PYRAMID.items():
        k = k.replace(f"pyramid.{new}.", f"pyramid.{old}.")
    k = re.sub(r"t_embedder\.mlp_(\d)\.", r"t_embedder.mlp.\1.", k)
    k = k.replace("adaLN_modulation_1.", "adaLN_modulation.1.")
    return re.sub(r"([hw])_scale_(\d)\.", r"\1_scale.\2.", k)


def _line_ref_key(k):
    m = re.match(r"(inc|down\d|up\d)\.(conv_0|bn_1|conv_3|bn_4)\.(.*)", k)
    if m is None:
        return k.replace("outc.", "outc.conv.")
    blk, part, rest = m.groups()
    mid = {"i": "double_conv", "d": "maxpool_conv.1.double_conv",
           "u": "conv.double_conv"}[blk[0]]
    return f"{blk}.{mid}.{_DOUBLE[part]}.{rest}"


def _reference_state_dict(sd, rename):
    """A port state_dict under the reference torch checkpoint's names:
    module paths renamed, norm ``scale`` -> ``weight``, BN statistics ->
    ``running_*``, and the cross-attention q/k/v projections packed into
    ``nn.MultiheadAttention``'s ``in_proj_*``."""
    out, packed = {}, {}
    for k, v in sd.items():
        r = _ref_leaf(rename(k))
        m = re.match(r"(.*\.cross_attn)\.([qkv])_proj\.(weight|bias)$", r)
        if m:
            packed.setdefault((m.group(1), m.group(3)), {})[m.group(2)] = v
        else:
            out[r] = v.numpy()
    for (prefix, leaf), parts in packed.items():
        out[f"{prefix}.in_proj_{leaf}"] = torch.cat(
            [parts[c] for c in "qkv"]).numpy()
    return out


@pytest.mark.parametrize("family", ["dit", "u2netp", "line_unet"])
def test_bridge_round_trips_with_dvd_tpu_converter(family):
    """port state_dict -> reference names -> dvd_tpu's convert_state_dict
    -> flax variables (whose tree matches the flax module's init) -> the
    port's bridge -> the same state_dict."""
    g = torch.Generator().manual_seed(3)
    if family == "dit":
        make = lambda: dit.DiT(**MINI)
        rules, rename = jconvert.DIT_RULES, _dit_ref_key
        _, flax_vars = _jax_dit()
    elif family == "u2netp":
        make = lambda: u2net.Seg(64)
        rules, rename = jconvert.U2NETP_RULES, lambda k: k
        flax_vars = _init(ju2net.Seg(64), jnp.zeros((1, 32, 32, 3)))
    else:
        make = textline_unet.TextLineUNet
        rules, rename = jconvert.LINE_UNET_RULES, _line_ref_key
        flax_vars = _init(jline.TextLineUNet(), jnp.zeros((1, 32, 32, 3)))
    sd = layers.seeded_init_(make(), g).state_dict()
    ref_sd = _reference_state_dict(sd, rename)
    variables = jconvert.convert_state_dict(ref_sd, rules)
    for coll in ("params", "batch_stats"):
        assert jconvert.validate_against(variables, flax_vars, coll) == []
    back, report = variables_to_state_dict(variables, make())
    assert report == ([], [], [])
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_bn_fold_follows_loaded_weights():
    """K2's folded (weight, scale, bias) is cached per weight set: loading
    new weights in place must refresh it."""
    conv = u2net.REBNCONV(4, 6, dirate=2)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 4, 7, 9, generator=g)

    def plain(m):
        inv, shift = m.bn_s1.affine()
        y = torch.nn.functional.conv2d(x, m.conv_s1.weight, m.conv_s1.bias,
                                       padding=2, dilation=2)
        return torch.relu(y * inv[:, None, None] + shift[:, None, None])

    with torch.no_grad():
        first = conv(x)
        torch.testing.assert_close(first, plain(conv), rtol=1e-5, atol=1e-5)
        fresh = layers.seeded_init_(u2net.REBNCONV(4, 6, dirate=2), g)
        conv.load_state_dict(fresh.state_dict())
        second = conv(x)
    assert not torch.allclose(first, second)
    torch.testing.assert_close(second, plain(conv), rtol=1e-5, atol=1e-5)


def test_fold_cache_rebuilds_k_major_copy_after_load():
    """In bf16 the fold cache also keeps the bf16 kernel's K-major weight
    operand, built once per weight set: repeated calls reuse it, and
    loading new weights in place rebuilds it from the new fold."""
    conv = u2net.REBNCONV(4, 6, dirate=2)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 4, 7, 9, generator=g).bfloat16()

    def cached():
        w, _, _, wk = conv.conv_s1.__dict__["_k2_fold"][1]
        torch.testing.assert_close(wk, k_major_weights(w), rtol=0, atol=0)
        assert wk.dtype == torch.bfloat16
        return wk

    with torch.no_grad():
        conv(x)
        first = cached()
        conv(x)
        assert cached() is first
        fresh = layers.seeded_init_(u2net.REBNCONV(4, 6, dirate=2), g)
        conv.load_state_dict(fresh.state_dict())
        conv(x)
    second = cached()
    assert second is not first and not torch.equal(second, first)
    torch.testing.assert_close(
        second, k_major_weights(fresh.conv_s1.weight), rtol=0, atol=0)
