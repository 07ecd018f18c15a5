"""Each kernel's plain twin (the port's CPU path and the kernel's oracle on
the card) against the TPU Pallas kernel it replaces, run in interpret mode
as the JAX package's own tests run it.  f32; tolerances per case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.ops.pallas.attention import fused_attention
from dvd_tpu.ops.pallas.grid_sample import gather_bilinear_planar
from dvd_tpu.ops.pallas.planar_conv import conv3x3_planar, pad_p
from dvd_tpu_torch.ops.kernels.attention import attention_ref
from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3_ref
from dvd_tpu_torch.ops.kernels.grid_sample import gather_bilinear_ref
from test_torch_common import t


@pytest.mark.parametrize("shape_q,tk,scale", [
    ((1, 2, 64, 16), 64, None),        # DiT-mini heads (Dh 16)
    ((1, 2, 64, 64), 64, 1 / 8),       # DiT-S/2 heads, scale 1/8
    ((1, 1, 32, 256), 32, 1 / 16),     # SATRN heads, scale 1/16
    ((1, 2, 40, 64), 96, 1 / 8),       # Tq != Tk
])
def test_attention_twin_matches_pallas(shape_q, tk, scale):
    b, h, tq, dh = shape_q
    rng = np.random.RandomState(0)
    q = rng.randn(b, h, tq, dh).astype(np.float32)
    k = rng.randn(b, h, tk, dh).astype(np.float32)
    v = rng.randn(b, h, tk, dh).astype(np.float32)
    want = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), scale=scale,
                                      interpret=True))
    s = scale if scale is not None else 1.0 / np.sqrt(dh)
    got = attention_ref(t(q), t(k), t(v), s).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("cin,cout,hw,dil", [
    (5, 6, (9, 7), 1),      # odd plane
    (5, 6, (9, 7), 2),
    (8, 6, (9, 9), 4),
    (8, 4, (9, 9), 8),      # dilation 8 on a 9x9 plane: most taps in the pad
    (3, 16, (16, 11), 1),   # image entry (Cin 3)
])
def test_conv3x3_twin_matches_pallas(cin, cout, hw, dil):
    h, w = hw
    rng = np.random.RandomState(cin * 100 + dil)
    x = rng.randn(2, cin, h, w).astype(np.float32)
    wk = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)   # HWIO
    scale = (rng.randn(cout) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    pp = pad_p(h, w)
    x_pl = np.zeros((2, cin, pp), np.float32)
    x_pl[:, :, :h * w] = x.reshape(2, cin, h * w)
    want = np.asarray(conv3x3_planar(
        jnp.asarray(x_pl), jnp.asarray(wk), jnp.asarray(scale),
        jnp.asarray(bias), hw=hw, dilation=dil, act="relu", interpret=True))
    want = want[:, :, :h * w].reshape(2, cout, h, w)   # pad lanes are junk
    got = conv3x3_ref(t(x), t(wk.transpose(3, 2, 0, 1)), t(scale), t(bias),
                      dil, True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_gather_twin_matches_pallas(padding_mode):
    rng = np.random.RandomState(5)
    n, c, h, w, p, q = 1, 2, 16, 128, 8, 128
    img = rng.rand(n, c, h, w).astype(np.float32)
    gx = rng.uniform(-3, w + 2, (n, p, q)).astype(np.float32)
    gy = rng.uniform(-3, h + 2, (n, p, q)).astype(np.float32)
    want = np.asarray(gather_bilinear_planar(
        jnp.asarray(img), jnp.asarray(gx), jnp.asarray(gy),
        padding_mode=padding_mode, interpret=True))
    got = gather_bilinear_ref(t(img), t(gx), t(gy), padding_mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
