"""The f32 kernels' arithmetic on the CPU: K1's and K2's float32 routes
(``csrc/attention_f32x6.cu``, ``csrc/conv3x3_f32x6.cu``) split each f32
operand into three bf16 parts (``split3_bf16``) and take every product as
six bf16 products summed in f32.  The kernels run only on the card; here
that arithmetic is emulated step by step in plain torch (k16 steps, the
six products smallest first, K1's tiles and online softmax) and held to
float64 and to ``dvd_tpu``'s Pallas kernels in f32, run in interpret mode
as ``tests/test_torch_kernels_ref.py`` runs them.

Bars: the emulation's max error against float64 is at most twice the f32
twin's own (``attention_ref``, ``conv3x3_ref``) or 2^-22 of max|ref|,
whichever is larger; against the Pallas kernels it is within the f32
bars the card's kernels meet against their twins (1e-4).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.ops.pallas.attention import fused_attention
from dvd_tpu_torch.models import layers, u2net
from dvd_tpu_torch.ops.kernels.attention import attention_ref, pad_head_dim
from dvd_tpu_torch.ops.kernels.conv3x3 import (_k_major, chunk_channels,
                                               conv3x3_ref, k_major_cols,
                                               k_major_weights,
                                               k_major_weights_split,
                                               split3_bf16)
from test_torch_common import t
from test_torch_kernels_ref import (ATTENTION_CASES, CONV_CASES, _conv_inputs,
                                    _conv_pallas)

F32 = torch.float32
# the six products of a k16 step, smallest terms first: (part of a, part
# of b), parts 0, 1, 2 = h, m, l
PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _f32_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.uint32).view(np.float32).copy())


def _split_inputs(kind: str, n: int = 1 << 16) -> torch.Tensor:
    """f32 values with |x| in [2^-100, 2^100], both signs: random bits, or
    rounding ties at the first split (x half a bf16 step from h) or at the
    second (x - h half a bf16 step of m from m)."""
    rng = np.random.RandomState(len(kind))
    sign = rng.randint(0, 2, n).astype(np.uint32) << 31
    expo = rng.randint(127 - 100, 127 + 100, n).astype(np.uint32) << 23
    mant = rng.randint(0, 1 << 23, n).astype(np.uint32)
    if kind == "tie_h":      # low 16 bits 0x8000: a tie in bf16(x)
        mant = (mant & 0x7F0000) | 0x8000
    elif kind == "tie_m":    # a tie one split down: bits 7 set, 0-6 clear
        mant = (mant & 0x7FFF00) | 0x80
    elif kind == "powers":   # exact powers of two and their neighbours
        mant = rng.choice(np.array([0, 1, 0x7FFFFF, 0x10000, 0xFFFF], np.uint32), n)
    x = _f32_bits(sign | expo | mant)
    assert x.abs().min() >= 2.0 ** -100 and x.abs().max() <= 2.0 ** 100
    return x


@pytest.mark.parametrize("kind", ["random", "tie_h", "tie_m", "powers"])
def test_split_is_exact(kind):
    """h + m + l == x bit for bit (summed in float64), each part a bf16
    rounded to nearest from what the parts before it left."""
    x = _split_inputs(kind)
    h, m, l = split3_bf16(x)
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    total = h.double() + m.double() + l.double()
    assert torch.equal(total, x.double())
    assert torch.equal(h, x.to(torch.bfloat16))
    assert torch.equal(m, (x - h.float()).to(torch.bfloat16))


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 16), (20, 8), (130, 33)])
def test_weight_split_sums_back(cin, cout):
    """The f32 kernel's weight operand: three bf16 planes that sum back to
    the K-major f32 weights exactly (chunks of 8 channels at Cin <= 8, else
    16), whose h plane at Cin <= 16 is the bf16 kernel's operand."""
    g = torch.Generator().manual_seed(cin)
    w = torch.randn(cout, cin, 3, 3, generator=g) / (3 * cin ** 0.5)
    wk3 = k_major_weights_split(w)
    cols = k_major_cols(cin, F32)
    assert wk3.dtype == torch.bfloat16 and wk3.shape == (3, cout, cols)
    assert wk3.is_contiguous()
    assert chunk_channels(cin, F32) == (8 if cin <= 8 else 16)
    want = _k_major(w, chunk_channels(cin, F32))
    assert want.shape == (cout, cols)
    assert torch.equal(wk3.double().sum(0), want.double())
    if cin <= 16:
        assert torch.equal(wk3[0], k_major_weights(w))


def mm_f32x6(a: torch.Tensor, b: torch.Tensor, per_step: bool = True):
    """a (..., M, K) @ b (..., K, N) as the f32 kernels compute it: K in
    steps of 16, each step's six products of bf16 parts (exact in f32)
    summed in f32, smallest terms first, into a partial sum that is added
    to the f32 total after every step (``per_step``; K1's S and K2) or
    after the last (K1's P V over one tile)."""
    pa, pb = split3_bf16(a.float()), split3_bf16(b.float())
    total = part = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=F32)
    for k0 in range(0, a.shape[-1], 16):
        for i, j in PAIRS:
            part = part + torch.matmul(pa[i][..., k0:k0 + 16].float(),
                                       pb[j][..., k0:k0 + 16, :].float())
        if per_step:
            total, part = total + part, torch.zeros_like(part)
    return total + part


def attention_f32x6(q, k, v, scale: float) -> torch.Tensor:
    """K1's f32 kernel step by step: the head dim zero-padded to its
    instance, K/V tiles of BK rows (32 at Dh >= 192, else 64), logits (at
    Dh 256 two halves of Dh summed apart, then added) scaled by f32(scale
    * log2 e), the online softmax (running max and sum, exp2, O rescaled
    per tile) and O normalised at the end."""
    dh = q.shape[-1]
    q, k, v = pad_head_dim(q, k, v)
    bk = 32 if q.shape[-1] >= 192 else 64
    c = torch.tensor(scale, dtype=F32) * torch.tensor(math.log2(math.e), dtype=F32)
    mx = torch.full(q.shape[:-1], -math.inf)
    total = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for t0 in range(0, k.shape[-2], bk):
        kt = k[..., t0:t0 + bk, :].transpose(-1, -2)
        if q.shape[-1] >= 256:
            half = q.shape[-1] // 2
            s = mm_f32x6(q[..., :half], kt[..., :half, :]) \
                + mm_f32x6(q[..., half:], kt[..., half:, :])
        else:
            s = mm_f32x6(q, kt)
        s = s * c
        new = torch.maximum(mx, s.amax(-1))
        alpha = torch.exp2(mx - new)
        p = torch.exp2(s - new[..., None])
        total = total * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm_f32x6(p, v[..., t0:t0 + bk, :], False)
        mx = new
    return (acc / total[..., None])[..., :dh]


def conv3x3_f32x6(x, w, scale, bias, dil: int, relu: bool = True):
    """K2's f32 kernel step by step: the implicit GEMM's columns in the
    kernel's order (chunks of ``chunk_channels(Cin, float32)``, taps, then
    channels, each chunk padded to a multiple of 16) against the split
    K-major weights, then the epilogue fmaf(acc, scale, bias) (one
    rounding) and the ReLU."""
    b, cin, h, wd = x.shape
    cc = chunk_channels(cin, F32)
    nch = -(-cin // cc)
    wk = _k_major(w, cc)
    kc = wk.shape[1] // nch
    xp = F.pad(x, (0, 0, 0, 0, 0, nch * cc - cin))
    cols = F.unfold(xp, 3, dilation=dil, padding=dil)
    cols = cols.reshape(b, nch, cc, 9, -1).transpose(2, 3).reshape(b, nch, 9 * cc, -1)
    cols = F.pad(cols, (0, 0, 0, kc - 9 * cc)).reshape(b, nch * kc, -1)
    acc = mm_f32x6(cols.transpose(1, 2), wk.t())               # (B, HW, Cout)
    y = (acc.double() * scale.double() + bias.double()).float()
    if relu:
        y = torch.relu(y)
    return y.transpose(1, 2).reshape(b, -1, h, wd)


def _err(got, want) -> float:
    return (got.double() - want.double()).abs().max().item()


def _check_vs_f64(name, emul, twin, ref64):
    e, tw = _err(emul, ref64), _err(twin, ref64)
    bar = max(2 * tw, 2.0 ** -22 * ref64.abs().max().item())
    assert e <= bar, f"{name}: emulation {e:.3e} vs f64, twin {tw:.3e}, bar {bar:.3e}"


@pytest.mark.parametrize("shape_q,tk,scale", ATTENTION_CASES + [
    ((1, 2, 70, 256), 100, 1 / 16),    # ragged, several 32-row tiles
    ((2, 2, 50, 64), 200, 1 / 8)])     # several 64-row tiles, a ragged one
def test_attention_emulation_is_f32_accurate(shape_q, tk, scale):
    b, h, tq, dh = shape_q
    rng = np.random.RandomState(dh + tk)
    q, k, v = (rng.randn(b, h, n, dh).astype(np.float32) for n in (tq, tk, tk))
    s = scale if scale is not None else 1.0 / np.sqrt(dh)
    emul = attention_f32x6(t(q), t(k), t(v), s)
    ref64 = attention_ref(*(t(a).double() for a in (q, k, v)), s)
    twin = attention_ref(t(q), t(k), t(v), s)
    _check_vs_f64(f"attention {shape_q} tk {tk}", emul, twin, ref64)
    if tk % 8 == 0:   # the Pallas kernel asserts it
        pallas = np.asarray(fused_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
            interpret=True))
        np.testing.assert_allclose(emul.numpy(), pallas, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cin,cout,hw,dil", CONV_CASES + [
    (20, 6, (9, 7), 1),      # two 16-channel chunks, the second ragged
    (4, 5, (12, 10), 3)])    # Cin 4: two taps per k16 step
def test_conv3x3_emulation_is_f32_accurate(cin, cout, hw, dil):
    x, wk, scale, bias = _conv_inputs(cin, cout, hw, dil)
    w = wk.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    emul = conv3x3_f32x6(t(x), t(w), t(scale), t(bias), dil)
    ref64 = conv3x3_ref(t(x).double(), t(w).double(), t(scale).double(),
                        t(bias).double(), dil, True)
    twin = conv3x3_ref(t(x), t(w), t(scale), t(bias), dil, True)
    _check_vs_f64(f"conv3x3 {cin}->{cout} @{hw} d{dil}", emul, twin, ref64)
    pallas = _conv_pallas(x, wk, scale, bias, hw, dil, jnp.float32)
    np.testing.assert_allclose(emul.numpy(), pallas, rtol=0,
                               atol=1e-4 * np.abs(pallas).max())


def test_fold_cache_rebuilds_split_after_load():
    """In f32 the fold cache keeps the f32 kernel's split weight operand,
    keyed as the bf16 copy is: repeated calls reuse it, and loading new
    weights in place rebuilds it from the new fold."""
    conv = u2net.REBNCONV(4, 6, dirate=2)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(1, 4, 7, 9, generator=g)

    def cached():
        w, _, _, wk3 = conv.conv_s1.__dict__["_k2_fold"][1]
        assert wk3.dtype == torch.bfloat16 and wk3.shape[0] == 3
        torch.testing.assert_close(wk3, k_major_weights_split(w), rtol=0, atol=0)
        return wk3

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
        second, k_major_weights_split(fresh.conv_s1.weight), rtol=0, atol=0)
