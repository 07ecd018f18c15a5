"""Each kernel's plain twin (the port's CPU path and the kernel's oracle on
the card) against the TPU Pallas kernel it replaces, run in interpret mode
as the JAX package's own tests run it.  f32, and attention also in bf16,
the dtype it is served in; tolerances per case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.ops.grid_sample import _warp_const_src_pallas_interpret
from dvd_tpu.ops.pallas.attention import fused_attention
from dvd_tpu.ops.pallas.grid_sample import (gather_bilinear_grad_planar,
                                            gather_bilinear_planar,
                                            grid_sample_pallas)
from dvd_tpu.ops.pallas.planar_conv import conv3x3_planar, pad_p
from dvd_tpu_torch.ops.kernels.attention import (attention_ref,
                                                 kernel_head_dim, pad_head_dim)
from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3_ref
from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear_grad,
                                                   gather_bilinear_grid,
                                                   gather_bilinear_ref)
from test_torch_common import nchw, t


ATTENTION_CASES = [
    ((1, 2, 64, 16), 64, None),        # DiT-mini heads (Dh 16)
    ((1, 2, 64, 64), 64, 1 / 8),       # DiT-S/2 heads, scale 1/8
    ((1, 1, 32, 256), 32, 1 / 16),     # SATRN heads, scale 1/16
    ((1, 2, 40, 64), 96, 1 / 8),       # Tq != Tk (Tk a multiple of 8, as
                                       # the Pallas kernel asserts)
    ((1, 2, 48, 72), 48, None),        # DiT-XL heads (Dh 72, padded to 128
]                                      # by both kernels)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_72_zero_padding_is_exact(dtype):
    """DiT-XL's head dim 72 has no kernel instance: the wrapper pads q, k
    and v with zero columns to 128 and slices the output.  The padded
    attention at scale 1/sqrt(72), never 1/sqrt(128), is the Dh 72 one:
    zero columns add nothing to q k^T or to the kept columns of P V (the
    f32 sums may run in another order: 1e-6; in bf16 the same one ulp)."""
    assert kernel_head_dim(72) == 128 and kernel_head_dim(64) == 64
    g = torch.Generator().manual_seed(72)
    q, k, v = (torch.randn(2, 16, n, 72, generator=g).to(dtype)
               for n in (40, 56, 56))
    qp, kp, vp = pad_head_dim(q, k, v)
    assert qp.shape[-1] == 128 and not qp[..., 72:].any()
    got = attention_ref(qp, kp, vp, 72 ** -0.5)[..., :72]
    want = attention_ref(q, k, v, 72 ** -0.5)
    atol = 1e-6 if dtype == torch.float32 else \
        2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_gather_grid_entry_matches_pallas(padding_mode):
    """K3's grid entry (its plain path on the CPU) against the JAX
    package's ``grid_sample_pallas`` in interpret mode: the [-1, 1] grid
    unnormalised in f32, then the gather, at shapes the TPU kernel tiles;
    coordinates reach out of range on every side."""
    rng = np.random.RandomState(7)
    img = rng.rand(2, 16, 128, 3).astype(np.float32)            # NHWC
    grid = rng.uniform(-1.1, 1.1, (2, 8, 128, 2)).astype(np.float32)
    want = np.asarray(grid_sample_pallas(
        jnp.asarray(img), jnp.asarray(grid), padding_mode=padding_mode,
        interpret=True))
    got = gather_bilinear_grid(nchw(img), t(grid), padding_mode)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)


def _off_integers(x, margin=0.02):
    """Pixel coordinates pushed at least ``margin`` away from the integers,
    where bilinear sampling has its kink."""
    frac = x - np.floor(x)
    x = np.where(frac < margin, x + margin, x)
    return np.where(frac > 1 - margin, x - margin, x).astype(np.float32)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_gather_grad_grid_layout_matches_dvd_tpu(padding_mode):
    """K4 in the grid layout (its plain path on the CPU): d/dgrid, (N, P,
    Q, 2), with the factor 0.5 (size - 1) applied inside.  'zeros' against
    the grid cotangent of ``dvd_tpu``'s ``warp_const_src`` (its Pallas
    pair in interpret mode), 'border' against ``gather_bilinear_grad_planar``
    chained through the same factor; 1e-5 of the largest (the factor is
    63.5 here, so the f32 rounding is relative)."""
    rng = np.random.RandomState(11)
    n, c, h, w, p, q = 2, 2, 16, 128, 8, 128
    img = rng.rand(n, h, w, c).astype(np.float32)               # NHWC
    gx = _off_integers(rng.uniform(-2, w + 1, (n, p, q)))
    gy = _off_integers(rng.uniform(-2, h + 1, (n, p, q)))
    grid = np.stack([gx / (0.5 * (w - 1)) - 1, gy / (0.5 * (h - 1)) - 1],
                    -1).astype(np.float32)
    ct = rng.randn(n, p, q, c).astype(np.float32)
    if padding_mode == "zeros":
        _, vjp = jax.vjp(_warp_const_src_pallas_interpret, jnp.asarray(img),
                         jnp.asarray(grid))
        want = np.asarray(vjp(jnp.asarray(ct))[1])
    else:
        gxu = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
        gyu = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
        ggx, ggy = gather_bilinear_grad_planar(
            jnp.asarray(img.transpose(0, 3, 1, 2)), jnp.asarray(gxu),
            jnp.asarray(gyu), jnp.asarray(ct.transpose(0, 3, 1, 2)),
            padding_mode="border", interpret=True)
        want = np.stack([np.asarray(ggx) * (0.5 * (w - 1)),
                         np.asarray(ggy) * (0.5 * (h - 1))], -1)
    got = gather_bilinear_grad(nchw(img), t(grid), nchw(ct), padding_mode)
    assert got.shape == (n, p, q, 2)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
