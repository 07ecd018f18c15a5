"""Bilinear resize (port of ``dvd_tpu/ops/resize.py:resize_bilinear``).

torch ``F.interpolate`` semantics for both ``align_corners`` settings,
computed as ``dvd_tpu`` does: two separable interpolation matrices built
in float64 numpy, applied with f32 matmuls (exact f32 on the CPU, and on
the card while ``torch.backends.cuda.matmul.allow_tf32`` is False, its
default).  The matrices are cached per (size, device, dtype), so a call
makes no host-to-device copy.  NCHW in, NCHW out.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_weights_np(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) row-stochastic bilinear interpolation matrix."""
    w = np.zeros((n_out, n_in), dtype=np.float64)
    if n_in == 1:
        w[:, 0] = 1.0
        return w.astype(np.float32)
    for i in range(n_out):
        if align_corners:
            src = 0.0 if n_out == 1 else i * (n_in - 1) / (n_out - 1)
        else:
            # torch: max(0, (i + 0.5) * in/out - 0.5)
            src = max((i + 0.5) * n_in / n_out - 0.5, 0.0)
        lo = min(int(np.floor(src)), n_in - 1)
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _linear_weights(n_in: int, n_out: int, align_corners: bool,
                    device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_linear_weights_np(n_in, n_out, align_corners)) \
        .to(device, dtype)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of an (N, C, H, W) tensor to ``size``; identity when
    the size already matches.  Returns a contiguous tensor."""
    h, w = x.shape[-2:]
    ho, wo = size
    if (h, w) == (ho, wo):
        return x
    a = _linear_weights(h, ho, align_corners, x.device, x.dtype)
    b = _linear_weights(w, wo, align_corners, x.device, x.dtype)
    return torch.matmul(torch.matmul(a, x), b.t())
