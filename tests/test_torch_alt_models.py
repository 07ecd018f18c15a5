"""The alternative denoisers' modules in the port against ``dvd_tpu`` at f32
on the CPU: ``GroupNorm32``, the UNet's ``ResBlock`` (both norm branches,
with and without the 1x1 skip) and ``AttentionBlock`` (a head dim K1 has
an instance for, and Dh 96, which K1 serves zero-padded to 128), nearest
x2 upsampling, ``UNetDenoiser`` in every input mode, the transformer
denoiser, ``BasicEncoder2`` and ``GeoTr2``.

Both sides get the same seeded weights (``random_variables``: the
zero-initialised ``conv_out``, ``proj_out`` and ``out_conv`` drawn small,
so that the blocks reach the output) through the bridge, and the same
numpy inputs.  Bars: a block within 1e-5 x max(1, max|ref|) (flax's
GroupNorm takes E[x^2] - E[x]^2, the port two passes: about 1e-6 of the
signal at f32), a whole model within 1e-4 x max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.models import geotr as jgeotr
from dvd_tpu.models import transformer_denoiser as jtd
from dvd_tpu.models import unet_denoiser as jud
from dvd_tpu.models.layers import GroupNorm32 as JGroupNorm32
from dvd_tpu_torch.models import geotr, transformer_denoiser, unet_denoiser
from dvd_tpu_torch.models.layers import GroupNorm32
from test_torch_common import nchw, nhwc, port, random_variables, t

S = 16
BLOCK_REL = 1e-5
MODEL_REL = 1e-4


def _close(got, want, rel, floor=0.0):
    want = np.asarray(want)
    bar = rel * max(floor, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bar, f"max err {err:.3e} > {bar:.3e}"


def _x(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("c,offset", [(32, 0.0), (96, 0.0), (16, 3.0)])
def test_group_norm32(c, offset):
    """min(32, C) groups, eps 1e-5; also a plane whose mean is large
    against its spread."""
    rng = np.random.RandomState(c)
    x = _x(rng, 2, 5, 7, c) + offset
    jm = JGroupNorm32(c)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want = jm.apply(v, jnp.asarray(x))
    got = port(GroupNorm32(c), v)(nchw(x))
    _close(nhwc(got), want, BLOCK_REL, 1.0)


@pytest.mark.parametrize("scale_shift", [True, False])
@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resblock(scale_shift, cin, cout):
    rng = np.random.RandomState(cin + cout)
    x, emb = _x(rng, 2, 8, 8, cin), _x(rng, 2, 128)
    jm = jud.ResBlock(cout, scale_shift)
    v = random_variables(jm, jnp.asarray(x), jnp.asarray(emb), seed=2)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(emb))
    pm = port(unet_denoiser.ResBlock(cin, cout, 128, scale_shift), v)
    assert (pm.skip_connection is None) == (cin == cout)
    with torch.no_grad():
        got = pm(nchw(x), t(emb))
    _close(nhwc(got), want, BLOCK_REL, 1.0)


@pytest.mark.parametrize("c,heads,hw", [(64, 2, 8), (192, 2, 4)],
                         ids=["dh32", "dh96-padded"])
def test_attention_block(c, heads, hw):
    """dvd_tpu scales q and k by Dh^-1/4 each; the port passes 1/sqrt(Dh)
    once to K1 (1/sqrt(96) at Dh 96, not the padded instance's 128)."""
    rng = np.random.RandomState(c)
    x = _x(rng, 2, hw, hw + 1, c)
    jm = jud.AttentionBlock(heads)
    v = random_variables(jm, jnp.asarray(x), seed=3)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(unet_denoiser.AttentionBlock(c, heads), v)(nchw(x))
    assert np.abs(np.asarray(want) - x).max() > 1e-2   # attention reached
    _close(nhwc(got), want, BLOCK_REL, 1.0)


@pytest.mark.parametrize("h,w", [(4, 4), (5, 7), (3, 6)])
def test_nearest_x2(h, w):
    """jax.image.resize(..., 'nearest') at a factor of 2 equals
    F.interpolate(scale_factor=2, mode='nearest'), odd and even planes."""
    x = _x(np.random.RandomState(h * w), 2, h, w, 3)
    want = jax.image.resize(jnp.asarray(x), (2, 2 * h, 2 * w, 3), "nearest")
    got = F.interpolate(nchw(x), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def _denoiser_inputs(seed, b=2):
    rng = np.random.RandomState(seed)
    return dict(x=_x(rng, b, S, S, 2, scale=0.5),
                t=np.array([133.0, 867.0][:b], np.float32),
                src_feat=_x(rng, b, S, S, 64, scale=0.3),
                init_flow=_x(rng, b, S, S, 2, scale=0.05),
                local_corr=_x(rng, b, S, S, 81, scale=0.3),
                trg_feat=_x(rng, b, S, S, 64))


UNET_CASES = {
    # mode: (in_channels, the inputs dvd_tpu's UNetDenoiser takes)
    "stage_1": (68, ("src_feat", "init_flow")),
    "stage_1-no-init-flow": (66, ("src_feat",)),
    "sr": (85, ("init_flow", "local_corr")),
    "trg_feat": (149, ("init_flow", "local_corr", "trg_feat")),
}


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_denoiser(case):
    """The tiny registry UNet (width 32, one ResBlock a level, attention at
    ds 2 and 4, channel_mult (1, 2, 2, 2)) in each input mode."""
    in_ch, keys = UNET_CASES[case]
    mode = case.split("-")[0]
    d = _denoiser_inputs(7)
    kw = dict(in_channels=in_ch, model_channels=32, num_res_blocks=1,
              attention_ds=(2, 4), channel_mult=(1, 2, 2, 2), num_heads=2,
              train_mode=mode)
    jm = jud.UNetDenoiser(**kw)
    jkw = {k: jnp.asarray(d[k]) for k in keys}
    v = random_variables(jm, jnp.asarray(d["x"]), jnp.asarray(d["t"]),
                         seed=4, **jkw)
    want = np.asarray(jm.apply(v, jnp.asarray(d["x"]), jnp.asarray(d["t"]),
                               **jkw))
    pm = port(unet_denoiser.UNetDenoiser(**kw), v)
    pkw = {k: t(d[k]) if k == "init_flow" else nchw(d[k]) for k in keys}
    with torch.no_grad():
        got = pm(t(d["x"]), t(d["t"]), **pkw).numpy()
    base = d["init_flow"] if "init_flow" in keys else 0.0
    assert np.abs(want - base).max() > 1e-2     # the blocks reached it
    _close(got, want, MODEL_REL)


def test_unet_denoiser_refuses_a_wrong_concat():
    pm = unet_denoiser.UNetDenoiser(68, 32, 2, 1, (2, 4), (1, 2, 2, 2), 2)
    d = _denoiser_inputs(1)
    with pytest.raises(ValueError, match="in_channels=68"):
        pm(t(d["x"]), t(d["t"]), src_feat=nchw(d["src_feat"]))


def test_transformer_denoiser():
    d = _denoiser_inputs(8)
    kw = dict(model_channels=32, num_heads=2, num_layers=2, ff_dim=64)
    jm = jtd.TransformerDenoiser(**kw)
    args = (jnp.asarray(d["x"]), jnp.asarray(d["t"]))
    jkw = dict(src_feat=jnp.asarray(d["src_feat"]),
               init_flow=jnp.asarray(d["init_flow"]))
    v = random_variables(jm, *args, seed=5, **jkw)
    want = np.asarray(jm.apply(v, *args, **jkw))
    pm = port(transformer_denoiser.TransformerDenoiser(**kw), v)
    with torch.no_grad():
        got = pm(t(d["x"]), t(d["t"]), src_feat=nchw(d["src_feat"]),
                 init_flow=t(d["init_flow"])).numpy()
    assert np.abs(want - d["init_flow"]).max() > 1e-2
    _close(got, want, MODEL_REL)


def test_basic_encoder2():
    x = _x(np.random.RandomState(9), 2, S, S, 68)
    jm = jgeotr.BasicEncoder2(64)
    v = random_variables(jm, jnp.asarray(x), seed=6)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(geotr.BasicEncoder2(68, 64), v)(nchw(x))
    assert got.shape == (2, 64, S // 2, S // 2)
    _close(nhwc(got), want, MODEL_REL)


def test_geotr2():
    """dvd_tpu's reading of upstream's GeoTr2 (the decoder takes its
    learned queries; a 1x1 projection into layer1_0), two layers."""
    d = _denoiser_inputs(10)
    jm = jgeotr.GeoTr2(num_attn_layers=2, latent=S)
    args = (jnp.asarray(d["x"]), jnp.asarray(d["t"]))
    jkw = dict(src_feat=jnp.asarray(d["src_feat"]),
               init_flow=jnp.asarray(d["init_flow"]))
    v = random_variables(jm, *args, seed=7, **jkw)
    want, none = jm.apply(v, *args, **jkw)
    assert none is None
    pm = port(geotr.GeoTr2(num_attn_layers=2, latent=S), v)
    with torch.no_grad():
        got = pm(t(d["x"]), t(d["t"]), src_feat=nchw(d["src_feat"]),
                 init_flow=t(d["init_flow"])).numpy()
    assert got.shape == (2, S, S, 2) and np.abs(np.asarray(want)).max() > 1e-2
    _close(got, want, MODEL_REL)
