"""Each kernel's plain twin (the port's CPU path and the kernel's oracle on
the card) against the TPU Pallas kernel it replaces, run in interpret mode
as the JAX package's own tests run it.  f32, and attention also in bf16,
the dtype it is served in; tolerances per case."""

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


ATTENTION_CASES = [
    ((1, 2, 64, 16), 64, None),        # DiT-mini heads (Dh 16)
    ((1, 2, 64, 64), 64, 1 / 8),       # DiT-S/2 heads, scale 1/8
    ((1, 1, 32, 256), 32, 1 / 16),     # SATRN heads, scale 1/16
    ((1, 2, 40, 64), 96, 1 / 8),       # Tq != Tk (Tk a multiple of 8, as
]                                      # the Pallas kernel asserts)


@pytest.mark.parametrize("shape_q,tk,scale", ATTENTION_CASES)
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


@pytest.mark.parametrize("shape_q,tk,scale", ATTENTION_CASES)
def test_attention_twin_matches_pallas_bf16(shape_q, tk, scale):
    """bf16 inputs, as served: the oracle the card's bf16 kernel is held
    to.  Both sides take f32 logits and softmax, cast p to bf16 before
    P.V and accumulate in f32; their f32 sums run in different orders, so
    an output may round to the neighbouring bf16 value: the bar is one
    bf16 ulp (8 significant bits) at the largest output."""
    b, h, tq, dh = shape_q
    rng = np.random.RandomState(1)
    # bf16 values held in f32, so both frameworks get the same numbers
    q, k, v = (t(rng.randn(b, h, n, dh).astype(np.float32)).to(torch.bfloat16)
               for n in (tq, tk, tk))
    want = fused_attention(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                             for x in (q, k, v)), scale=scale, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    s = scale if scale is not None else 1.0 / np.sqrt(dh)
    got = attention_ref(q, k, v, s)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ulp, rtol=0)


CONV_CASES = [
    (5, 6, (9, 7), 1),      # odd plane
    (5, 6, (9, 7), 2),
    (8, 6, (9, 9), 4),
    (8, 4, (9, 9), 8),      # dilation 8 on a 9x9 plane: most taps in the pad
    (3, 16, (16, 11), 1),   # image entry (Cin 3)
]


def _conv_inputs(cin, cout, hw, dil):
    h, w = hw
    rng = np.random.RandomState(cin * 100 + dil)
    x = rng.randn(2, cin, h, w).astype(np.float32)
    wk = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)   # HWIO
    scale = (rng.randn(cout) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, wk, scale, bias


def _conv_pallas(x, wk, scale, bias, hw, dil, dtype):
    """conv3x3_planar in interpret mode on NCHW x, in ``dtype``."""
    h, w = hw
    n, cin = x.shape[:2]
    x_pl = np.zeros((n, cin, pad_p(h, w)), np.float32)
    x_pl[:, :, :h * w] = x.reshape(n, cin, h * w)
    want = conv3x3_planar(
        jnp.asarray(x_pl, dtype), jnp.asarray(wk, dtype), jnp.asarray(scale),
        jnp.asarray(bias), hw=hw, dilation=dil, act="relu", interpret=True)
    assert want.dtype == dtype
    want = np.asarray(want.astype(jnp.float32))
    return want[:, :, :h * w].reshape(n, -1, h, w)   # pad lanes are junk


@pytest.mark.parametrize("cin,cout,hw,dil", CONV_CASES)
def test_conv3x3_twin_matches_pallas(cin, cout, hw, dil):
    x, wk, scale, bias = _conv_inputs(cin, cout, hw, dil)
    want = _conv_pallas(x, wk, scale, bias, hw, dil, jnp.float32)
    got = conv3x3_ref(t(x), t(wk.transpose(3, 2, 0, 1)), t(scale), t(bias),
                      dil, True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout,hw,dil", CONV_CASES + [
    (64, 8, (6, 10), 1)])   # Cin 64: the Pallas kernel's per-tap wide path
def test_conv3x3_twin_matches_pallas_bf16(cin, cout, hw, dil):
    """bf16 x and w, as served: the oracle the card's bf16 kernel is held
    to.  Both sides take bf16 products, sum in f32, apply the f32 affine
    and ReLU and round the output to bf16; their sums run in different
    orders, so an output may round to the neighbouring bf16 value: the bar
    is one bf16 ulp (8 significant bits) at the largest output."""
    x, wk, scale, bias = _conv_inputs(cin, cout, hw, dil)
    # bf16 values held in f32, so both frameworks get the same numbers
    xb = t(x).to(torch.bfloat16)
    wb = t(wk.transpose(3, 2, 0, 1)).to(torch.bfloat16)
    want = _conv_pallas(xb.float().numpy(),
                        wb.float().numpy().transpose(2, 3, 1, 0), scale, bias,
                        hw, dil, jnp.bfloat16)
    got = conv3x3_ref(xb, wb, t(scale), t(bias), dil, True)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ulp, rtol=0)


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
