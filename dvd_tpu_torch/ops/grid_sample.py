"""Bilinear grid sampling, ``align_corners=True`` (port of
``dvd_tpu/ops/grid_sample.py:grid_sample`` / ``warp``).

The image is NCHW (torch's ``F.grid_sample`` layout); the grid is
``(N, P, Q, 2)`` in [-1, 1] with x first.  Coordinates are unnormalised in
f32 (``(g + 1) * 0.5 * (size - 1)``, as ``grid_sample_pallas``) and handed
to K3 (``ops/kernels/grid_sample.py``), which launches the CUDA kernel for
CUDA tensors and takes its plain twin on the CPU.
"""

from __future__ import annotations

import torch

from dvd_tpu_torch.ops.kernels.grid_sample import gather_bilinear


def unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel coordinate, align_corners=True, in f32."""
    return (coord.float() + 1.0) * 0.5 * (size - 1)


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``img`` (N, C, H, W) at ``grid`` (N, P, Q, 2) -> (N, C, P, Q),
    bilinear, align_corners=True, 'zeros' or 'border' padding.  Computes in
    f32 and returns img's dtype."""
    if img.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2 \
            or grid.shape[0] != img.shape[0]:
        raise ValueError(f"bad shapes img={tuple(img.shape)} "
                         f"grid={tuple(grid.shape)}")
    h, w = img.shape[-2:]
    gx = unnormalize(grid[..., 0], w).contiguous()
    gy = unnormalize(grid[..., 1], h).contiguous()
    out = gather_bilinear(img.float().contiguous(), gx, gy, padding_mode)
    return out.to(img.dtype)


def warp(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The reference's ``register_model2([img, grid])``: grid in [-1, 1],
    align_corners=True, zero padding."""
    return grid_sample(img, grid, padding_mode="zeros")
