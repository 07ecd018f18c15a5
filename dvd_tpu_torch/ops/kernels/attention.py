"""K1: fused attention forward (``csrc/attention.cu``) and its plain twin.

Replaces ``dvd_tpu/ops/pallas/attention.py:fused_attention``.  The
wrapper reads q/k/v through their (b, h, t) strides, so the non-contiguous
``split_heads`` views go to the kernel without a copy; only the last (Dh)
dimension must be contiguous.  The output is allocated as a (B, T, H, Dh)
buffer and returned as its (B, H, T, Dh) view, so ``merge_heads`` is a
free reshape.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dvd_tpu_torch.ops.kernels import build

# head dims with a kernel (csrc/attention.cu DVD_FOR_EACH_DH): the mini
# test DiT (16), DiT-S/B/L (64), the SATRN decoder over 2-4 streams (64 * k)
HEAD_DIMS = (16, 64, 128, 192, 256)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Plain twin: logits and softmax in f32, p cast to v's dtype before
    P.V with f32 accumulation (as the TPU kernel's ``_kernel``), output in
    q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"attention: tensors on {q.device}, {k.device}, "
                         f"{v.device}; the kernel takes one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != dh:
        raise ValueError(f"attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {dh} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention: the head dim must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("attention kernel is forward-only")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, H, Tq, Dh) x (B, H, Tk, Dh).

    CPU tensors take the plain twin; CUDA tensors launch K1 or raise."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale)
    _check(q, k, v)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    out = torch.empty((b, tq, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    kl = build.load_library()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = kl.lib.dvd_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, tk, dh, *strides, scale, build.DTYPE_CODES[q.dtype],
        build.stream_ptr(q))
    build.check_launch(kl, err, "dvd_attention_fwd")
    attention.launches += 1
    return out


attention.launches = 0
