"""The training slice's ops of ``dvd_tpu_torch`` against ``dvd_tpu`` (CPU,
f32): K4's plain twin against the Pallas kernel in interpret mode,
``warp_const_src``, the attention backward, the trainable conv Function,
BatchNorm's train mode, the timestep samplers, and the port's own copy of
the config.

The Functions run their CPU path here (the kernels' plain twins), so these
tests go through the same autograd wiring the card uses.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu import config as jconfig
from dvd_tpu.ops.grid_sample import _warp_const_src_pallas_interpret
from dvd_tpu.ops.pallas import attention as jattn
from dvd_tpu.ops.pallas.grid_sample import gather_bilinear_grad_planar
from dvd_tpu.training import resample as jresample
from dvd_tpu_torch import config
from dvd_tpu_torch.models.layers import BatchNorm, commit_batch_stats, dropout
from dvd_tpu_torch.ops.grid_sample import warp_const_src
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.ops.kernels.attention import attention, attention_bwd
from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3_ref, conv3x3_trainable
from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear_grad_ref,
                                                   gather_bilinear_ref)
from dvd_tpu_torch.training import resample
from test_torch_common import nchw, t


def _off_integers(x: np.ndarray, margin: float = 1e-3) -> np.ndarray:
    """Coordinates pushed at least ``margin`` away from the integers, where
    bilinear sampling has its kink (the two frameworks could take the
    other corner pair there)."""
    frac = x - np.floor(x)
    x = np.where(frac < margin, x + margin, x)
    x = np.where(frac > 1 - margin, x - margin, x)
    assert np.abs(x - np.round(x)).min() >= margin * 0.999
    return x.astype(np.float32)


# ------------------------------------------------------------------- K4
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_gather_grad_twin_matches_pallas(c, padding_mode):
    """K4's plain twin against ``gather_bilinear_grad_planar`` in interpret
    mode, at shapes the TPU kernel tiles; coordinates reach out of range
    on every side."""
    rng = np.random.RandomState(c)
    n, h, w, p, q = 2, 16, 128, 8, 128
    img = rng.rand(n, c, h, w).astype(np.float32)
    gx = _off_integers(rng.uniform(-3, w + 2, (n, p, q)))
    gy = _off_integers(rng.uniform(-3, h + 2, (n, p, q)))
    ct = rng.randn(n, c, p, q).astype(np.float32)
    want = gather_bilinear_grad_planar(
        *(jnp.asarray(a) for a in (img, gx, gy, ct)),
        padding_mode=padding_mode, interpret=True)
    got = gather_bilinear_grad_ref(t(img), t(gx), t(gy), t(ct), padding_mode)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-5)
    # and the twin is the autograd of K3's twin, summed against ct
    gxt, gyt = t(gx).requires_grad_(), t(gy).requires_grad_()
    (gather_bilinear_ref(t(img), gxt, gyt, padding_mode) * t(ct)).sum() \
        .backward()
    np.testing.assert_allclose(gxt.grad.numpy(), got[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(gyt.grad.numpy(), got[1].numpy(), atol=1e-5)


def test_warp_const_src_matches_pallas_vjp():
    """Value and grid gradient of ``warp_const_src`` against the JAX
    package's Pallas pair (K3 forward, K4 backward) in interpret mode."""
    rng = np.random.RandomState(5)
    img = rng.rand(2, 16, 128, 2).astype(np.float32)         # NHWC
    gx = _off_integers(rng.uniform(-0.1, 127.1, (2, 8, 128)))
    gy = _off_integers(rng.uniform(-0.1, 15.1, (2, 8, 128)))
    grid = np.stack([gx / 127.0 * 2 - 1, gy / 15.0 * 2 - 1], -1) \
        .astype(np.float32)
    ct = rng.randn(2, 8, 128, 2).astype(np.float32)
    want, vjp = jax.vjp(_warp_const_src_pallas_interpret, jnp.asarray(img),
                        jnp.asarray(grid))
    want_img_ct, want_grid_ct = vjp(jnp.asarray(ct))
    gt = t(grid).requires_grad_()
    src = nchw(img).requires_grad_()
    got = warp_const_src(src, gt)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6)
    (got * nchw(ct)).sum().backward()
    # the grid gradient carries the unnormalisation factor (W - 1) / 2 =
    # 63.5, so its f32 rounding is relative: 1e-5 x max(1, max|g|)
    want_grid_ct = np.asarray(want_grid_ct)
    np.testing.assert_allclose(gt.grad.numpy(), want_grid_ct,
                               atol=1e-5 * max(1.0, np.abs(want_grid_ct).max()))
    assert not np.asarray(want_img_ct).any() and src.grad is None


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("dh", [16, 64])
def test_attention_bwd_matches_jax_vjp(dh):
    """``attention_bwd`` and the autograd Function against ``jax.vjp`` of
    the JAX package's fused attention (its recompute backward)."""
    rng = np.random.RandomState(dh)
    q, k, v = (rng.randn(2, 3, n, dh).astype(np.float32) for n in (24, 40, 40))
    g = rng.randn(2, 3, 24, dh).astype(np.float32)
    scale = 1.0 / np.sqrt(dh)
    want, vjp = jax.vjp(lambda a, b, c: jattn.attention(a, b, c, scale, True),
                        *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    got = attention_bwd(t(q), t(k), t(v), t(g), scale)
    for a, b in zip(got, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    out = attention(*qkv, scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    (out * t(g)).sum().backward()
    for a, b in zip(qkv, want_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-5)


# ----------------------------------------------------------------- conv
@pytest.mark.parametrize("dilation,relu", [(1, True), (2, False)])
def test_conv3x3_trainable_grads(dilation, relu):
    """The conv Function's gradients (x, w, b) against the autograd of the
    plain conv; w and b keep their f32 dtype."""
    g = torch.Generator().manual_seed(dilation)
    x = torch.randn(2, 5, 9, 11, generator=g)
    w = torch.randn(6, 5, 3, 3, generator=g) / 6
    b = torch.randn(6, generator=g) * 0.1
    ct = torch.randn(2, 6, 9, 11, generator=g)
    leaves = [a.clone().requires_grad_() for a in (x, w, b)]
    y = conv3x3_trainable(*leaves, dilation, relu)
    (y * ct).sum().backward()
    ref = [a.clone().requires_grad_() for a in (x, w, b)]
    want = F.conv2d(ref[0], ref[1], ref[2], 1, dilation, dilation)
    want = torch.relu(want) if relu else want
    (want * ct).sum().backward()
    torch.testing.assert_close(y.detach(), want.detach(), rtol=0, atol=1e-5)
    torch.testing.assert_close(
        y.detach(), conv3x3_ref(x, w, torch.ones(6), b, dilation, relu),
        rtol=0, atol=0)
    for a, r in zip(leaves, ref):
        torch.testing.assert_close(a.grad, r.grad, rtol=0, atol=1e-5)


# ------------------------------------------------------------ BatchNorm
def test_batchnorm_train_matches_flax():
    """Train mode: batch statistics (biased variance), flax's running-stat
    update with momentum 0.9, and gradients to scale and bias."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 6, 8) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    bias = (0.1 * rng.randn(8)).astype(np.float32)
    mean0 = rng.randn(8).astype(np.float32)
    var0 = rng.rand(8).astype(np.float32) + 0.5
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}

    def f(params, xx):
        y, st = mod.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * jnp.cos(xx)), (y, st["batch_stats"])

    (_, (want, stats)), want_g = jax.value_and_grad(f, has_aux=True)(
        variables["params"], jnp.asarray(x))
    bn = BatchNorm(8)
    with torch.no_grad():
        for name, val in (("scale", scale), ("bias", bias), ("mean", mean0),
                          ("var", var0)):
            getattr(bn, name).copy_(t(val))
    xt = t(x)
    y = bn(xt, train=True)
    (y * torch.cos(xt)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=1e-6)
    for name in ("scale", "bias"):   # sums over 240 terms of up to ~30
        np.testing.assert_allclose(getattr(bn, name).grad.numpy(),
                                   np.asarray(want_g[name]), rtol=1e-5,
                                   atol=1e-5)
    commit_batch_stats(bn)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(stats[name]), atol=1e-6)
    assert bn.batch_stats is None
    # eval mode still reads the running statistics
    bn2 = BatchNorm(8)
    torch.testing.assert_close(bn2(xt), xt / np.sqrt(1 + 1e-5), rtol=0,
                               atol=1e-6)


def test_dropout_keeps_expected_share():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = dropout(x, 0.1, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert dropout(x, 0.0, g) is x


# -------------------------------------------------------------- samplers
def test_loss_aware_sampler_matches_jax():
    """History ring, weights and warm-up against ``dvd_tpu``; the draws
    themselves come from different generators and are checked for range
    and the compensating weights."""
    T, H = 3, 4
    js = jresample.LossSecondMomentState.create(T, history_per_term=H)
    ts = resample.LossSecondMomentState.create(T, history_per_term=H)
    rng = np.random.RandomState(0)
    for i in range(6):
        tt = rng.randint(0, T, 5)
        ll = rng.rand(5).astype(np.float32)
        js = jresample.update_history(js, jnp.asarray(tt), jnp.asarray(ll))
        ts = resample.update_history(ts, torch.from_numpy(tt), t(ll))
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
        np.testing.assert_allclose(ts.history.numpy(), np.asarray(js.history),
                                   atol=0)
        np.testing.assert_allclose(resample.loss_aware_weights(ts).numpy(),
                                   np.asarray(jresample.loss_aware_weights(js)),
                                   atol=1e-7)
    g = torch.Generator().manual_seed(1)
    tt, w = resample.loss_aware_sample(g, 64, ts)
    p = resample.loss_aware_weights(ts)
    assert tt.min() >= 0 and tt.max() < T
    torch.testing.assert_close(w * p[tt] * T, torch.ones(64))
    tt, w = resample.uniform_sample(g, 16, T)
    assert tt.min() >= 0 and tt.max() < T and (w == 1).all()


# ---------------------------------------------------------------- config
def test_config_copy_matches_dvd_tpu():
    """The port's config is its own copy, field for field and default for
    default, with the same replace/to_dict/from_dict behaviour."""
    for name in ("DiffusionConfig", "ModelConfig", "TrainConfig",
                 "DataConfig", "ParallelConfig", "PathsConfig", "DvDConfig"):
        ours, theirs = getattr(config, name), getattr(jconfig, name)
        assert ours is not theirs
        assert [(f.name, f.default) for f in dataclasses.fields(ours)
                if f.default is not dataclasses.MISSING] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)
             if f.default is not dataclasses.MISSING]
    over = {"model": {"iter": False}, "train": {"lr": 3e-4,
                                                "ema_rate": "0.9,0.99"}}
    ours = config.default_config().replace(**over)
    theirs = jconfig.default_config().replace(**over)
    assert ours.to_dict() == theirs.to_dict()
    assert config.DvDConfig.from_dict(ours.to_dict()) == ours
    assert ours.train.ema_rates == theirs.train.ema_rates == (0.9, 0.99)


def test_resize_after_inference_mode_keeps_gradients():
    """The interpolation matrices are cached across calls: a cache filled
    under ``inference_mode`` (serving) must still serve an autograd caller
    (the training loss) in the same process."""
    with torch.inference_mode():
        resize_bilinear(torch.rand(1, 2, 7, 9), (23, 29), True)
    x = torch.rand(1, 2, 7, 9, requires_grad=True)
    resize_bilinear(x, (23, 29), True).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
