"""K5: exact integer 2-D gather (``csrc/gather_probe.cu``) beside its plain
twin.

K5 replaces the TPU kernel of ``tools/pallas_gather_probe.py`` (the
inline ``kernel``): ``out[i, j] = img[y[i, j], x[i, j]]`` for an (H, W)
float32 image and (M, N) int32 index planes, exactly.  An index outside
[0, H) x [0, W) yields 0.0, in the kernel and the twin alike (the TPU
probe never gives one).
"""

from __future__ import annotations

import torch

from dvd_tpu_torch.ops.kernels import build


def gather2d_ref(img: torch.Tensor, y: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain twin: ``img[y, x]``, 0.0 where an index is out of range."""
    h, w = img.shape
    valid = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    vals = img[y.clamp(0, h - 1).long(), x.clamp(0, w - 1).long()]
    return torch.where(valid, vals, torch.zeros((), dtype=img.dtype,
                                                device=img.device))


def gather2d(img: torch.Tensor, y: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """(H, W) f32 image gathered at (M, N) int32 indices -> (M, N) f32.
    CPU tensors take the plain twin; CUDA tensors launch K5 or raise."""
    if img.device.type == "cpu":
        return gather2d_ref(img, y, x)
    tensors = (img, y, x)
    if not img.is_cuda or any(t.device != img.device for t in tensors):
        raise ValueError("gather2d: inputs must share one CUDA device (got "
                         f"{[str(t.device) for t in tensors]})")
    if img.dtype != torch.float32 or y.dtype != torch.int32 \
            or x.dtype != torch.int32:
        raise TypeError(f"gather2d: float32 image and int32 indices (got "
                        f"{img.dtype}, {y.dtype}, {x.dtype})")
    if img.dim() != 2 or y.dim() != 2 or y.shape != x.shape:
        raise ValueError(f"gather2d: shapes {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather2d: inputs must be contiguous")
    h, w = img.shape
    out = torch.empty(y.shape, dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    kl = build.load_library()
    err = kl.lib.dvd_gather2d(img.data_ptr(), y.data_ptr(), x.data_ptr(),
                              out.data_ptr(), h, w, y.numel(),
                              build.stream_ptr(img))
    build.check_launch(kl, err, "dvd_gather2d")
    gather2d.launches += 1
    return out


gather2d.launches = 0
