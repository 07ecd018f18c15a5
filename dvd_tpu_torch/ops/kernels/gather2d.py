"""K5: exact integer 2-D gather (``csrc/gather_probe.cu``) beside its plain
twin.

K5 replaces the TPU kernel of ``tools/pallas_gather_probe.py`` (the
inline ``kernel``): ``out[i, j] = img[y[i, j], x[i, j]]`` for an (H, W)
float32 image and (M, N) int32 index planes, exactly.  An index outside
[0, H) x [0, W) yields 0.0, in the kernel and the twin alike (the TPU
probe never gives one).
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=1)
def _entry():
    """The C entry, fetched from the library once."""
    return build.load_library().lib.dvd_gather2d


def _refusal(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """Why the kernel does not take these inputs, as the exception to
    raise, or None when it takes them."""
    tensors = (img, y, x)
    if not img.is_cuda or y.device != img.device or x.device != img.device:
        return ValueError("gather2d: inputs must share one CUDA device (got "
                          f"{[str(t.device) for t in tensors]})")
    if img.dtype != torch.float32 or y.dtype != torch.int32 \
            or x.dtype != torch.int32:
        return TypeError(f"gather2d: float32 image and int32 indices (got "
                         f"{img.dtype}, {y.dtype}, {x.dtype})")
    if img.dim() != 2 or y.dim() != 2 or y.shape != x.shape:
        return ValueError(
            f"gather2d: shapes {[tuple(t.shape) for t in tensors]}")
    if not (img.is_contiguous() and y.is_contiguous() and x.is_contiguous()):
        return ValueError("gather2d: inputs must be contiguous")
    return None


def gather2d(img: torch.Tensor, y: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """(H, W) f32 image gathered at (M, N) int32 indices -> (M, N) f32.
    CPU tensors take the plain twin; CUDA tensors launch K5 or raise.
    Index planes that are offset views (not 16-byte aligned) take the
    kernel's scalar path."""
    if img.device.type == "cpu":
        return gather2d_ref(img, y, x)
    refusal = _refusal(img, y, x)
    if refusal is not None:
        raise refusal
    h, w = img.shape
    out = torch.empty(y.shape, dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    err = _entry()(img.data_ptr(), y.data_ptr(), x.data_ptr(),
                   out.data_ptr(), h, w, out.numel(), build.stream_ptr(img))
    if err:
        build.check_launch(build.load_library(), err, "dvd_gather2d")
    gather2d.launches += 1
    return out


gather2d.launches = 0
