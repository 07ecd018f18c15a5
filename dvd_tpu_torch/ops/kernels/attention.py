"""K1: fused attention forward and its plain twin.

Replaces ``dvd_tpu/ops/pallas/attention.py:fused_attention``.  CUDA
tensors go by dtype, both to the tensor cores: bf16 to
``csrc/attention_wgmma.cu`` (counted in ``attention.launches_wgmma``), f32
to ``csrc/attention_f32x6.cu`` (``attention.launches_f32``), which keeps
f32 accuracy with six bf16 products over a three-way bf16 split of each
operand (the TPU's ``precision=HIGHEST``); ``attention.launches`` counts
both, ``attention.launches_by_dh`` by the instance's head dim.  The
wrapper reads q/k/v through their (b, h, t) strides, so the
non-contiguous ``split_heads`` views go to the kernel without a copy; the
last (Dh) dimension must be contiguous.  The kernels' 16-byte async copies
need each base pointer 16-byte aligned and each stride a multiple of 16
bytes: a bf16 view that is not raises, an f32 view that is not is copied
into a fresh, aligned buffer first.  The output is allocated as a
(B, T, H, Dh) buffer and returned as its (B, H, T, Dh) view, so
``merge_heads`` is a free reshape.  The instances differ by dtype: the
bf16 kernel also has DiT-XL/2's head dim 72 (padded to 80 columns in
shared memory only), so DiT-XL's attention reads its views in place.  A
head dim without an instance in its dtype (up to 256: 72 in f32, the UNet
denoiser's 96 in both) is zero-padded to the next one (fresh, aligned
copies) and the output sliced back.

When a gradient is needed, ``attention`` goes through an autograd
Function: forward K1, backward ``attention_bwd``, the f32 recompute of
``dvd_tpu/ops/pallas/attention.py:_attention_bwd`` in plain torch (the
JAX package computes that backward outside Pallas too).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from dvd_tpu_torch.ops.kernels import build
from dvd_tpu_torch.utils.dtypes import at_least_f32

# head dims with a kernel in both dtypes (DVD_FOR_EACH_DH in both sources):
# the mini test DiT (16), GeoTr's transformer, GeoTr2 and the transformer
# denoiser (32), DiT-S/B/L (64), the UNet denoiser's 512-channel level
# (128), the SATRN decoder over 2-4 streams (64 * k)
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
# by dtype: the bf16 kernel adds DiT-XL/2's 72 (DVD_FOR_EACH_DH_BF16 in
# csrc/attention_wgmma.cu), so DiT-XL's bf16 attention is not padded; any
# other head dim up to 256 (72 in f32, the UNet denoiser's 96) is
# zero-padded to the next (kernel_head_dim)
HEAD_DIMS_BY_DTYPE = {torch.float32: HEAD_DIMS,
                      torch.bfloat16: tuple(sorted(HEAD_DIMS + (72,)))}
# CUDA entry by dtype
_ENTRIES = {torch.float32: "dvd_attention_fwd_f32x6",
            torch.bfloat16: "dvd_attention_fwd_wgmma"}


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Plain twin: logits and softmax in f32, p cast to v's dtype before
    P.V with f32 accumulation (as the TPU kernel's ``_kernel``), output in
    q's dtype."""
    logits = torch.matmul(at_least_f32(q),
                          at_least_f32(k).transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(at_least_f32(p), at_least_f32(v)).to(q.dtype)


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"attention: tensors on {q.device}, {k.device}, "
                         f"{v.device}; the kernel takes one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRIES:
        raise TypeError(f"attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != dh:
        raise ValueError(f"attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    kernel_head_dim(dh, q.dtype)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention: the head dim must be contiguous")
    # f32 views that are not aligned, and padded head dims, are copied
    if q.dtype == torch.bfloat16 and dh in HEAD_DIMS_BY_DTYPE[q.dtype]:
        for name, t in zip("qkv", (q, k, v)):
            if not _aligned(t):
                raise ValueError(
                    f"attention: bfloat16 {name} at byte offset "
                    f"{t.data_ptr() % 16} with strides {t.stride()}; the "
                    "kernel takes 16-byte aligned bases and strides that "
                    "are multiples of 8")


def _aligned(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte copies can read ``t`` in place: its
    base 16-byte aligned and its (b, h, t) strides multiples of 16 bytes."""
    per16 = 16 // t.element_size()   # elements per 16 bytes
    return not (t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:3]))


def kernel_head_dim(dh: int, dtype: torch.dtype) -> int:
    """The smallest head dim with a kernel instance in ``dtype`` that holds
    ``dh``.  A head dim without an instance of its own (72 in f32, the UNet
    denoiser's 96) is served as the reference's kernel serves every head
    dim, zero-padded (it pads Dh to a multiple of 128,
    ``dvd_tpu/ops/pallas/attention.py:61, 73-75``): zero columns change
    neither q k^T nor the kept columns of P V.  Such launches are counted
    in ``attention.launches_padded`` by the caller's head dim; the
    benchmark reads them a batch as ``k1_padded_launches.device_paced``
    (``perfbench/metrics/``)."""
    dims = HEAD_DIMS_BY_DTYPE[dtype]
    for d in dims:
        if d >= dh:
            return d
    raise ValueError(f"attention: head dim {dh} above the largest kernel "
                     f"head dim {dims[-1]}")


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v zero-padded along the head dim to :func:`kernel_head_dim` in
    q's dtype (the tensors themselves when it already has an instance)."""
    dh = q.shape[-1]
    pad = kernel_head_dim(dh, q.dtype) - dh
    if not pad:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, scale: float):
    """(dq, dk, dv) of softmax(q k^T * scale) v against the cotangent
    ``g``: the probabilities recomputed in f32 (flash-style
    rematerialisation), each gradient returned in its input's dtype."""
    with torch.autocast(q.device.type, enabled=False):
        q32, k32, v32, g32 = (at_least_f32(x) for x in (q, k, v, g))
        p = torch.softmax(torch.matmul(q32, k32.transpose(-1, -2)) * scale,
                          dim=-1)
        dv = torch.matmul(p.transpose(-1, -2), g32)
        dp = torch.matmul(g32, v32.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.matmul(ds, k32) * scale
        dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        return (*attention_bwd(*ctx.saved_tensors, g, ctx.scale), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, H, Tq, Dh) x (B, H, Tk, Dh).

    CPU tensors take the plain twin; CUDA tensors launch K1 or raise.  When
    a gradient is needed the call goes through the autograd Function."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


def _forward(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    _check(q, k, v)
    dh_in = q.shape[-1]
    q, k, v = (t if _aligned(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in pad_head_dim(q, k, v))
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    out = torch.empty((b, tq, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    kl = build.load_library()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    entry = _ENTRIES[q.dtype]
    err = getattr(kl.lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, tk, dh, *strides, scale, build.DTYPE_CODES[q.dtype],
        build.stream_ptr(q))
    build.check_launch(kl, err, entry)
    attention.launches += 1
    if q.dtype == torch.bfloat16:
        attention.launches_wgmma += 1
    else:
        attention.launches_f32 += 1
    attention.launches_by_dh[dh] += 1
    if dh != dh_in:
        attention.launches_padded[dh_in] += 1
        return out[..., :dh_in]
    return out


attention.launches = 0
attention.launches_wgmma = 0
attention.launches_f32 = 0
# launches by the kernel instance's head dim (a padded head dim counts as
# the instance it runs on)
attention.launches_by_dh = Counter()
# the padded launches by the caller's head dim (72 in f32, the UNet
# denoiser's 96)
attention.launches_padded = Counter()
