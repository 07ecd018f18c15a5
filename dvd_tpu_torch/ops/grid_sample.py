"""Bilinear grid sampling, ``align_corners=True`` (port of
``dvd_tpu/ops/grid_sample.py:grid_sample`` / ``warp``).

The image is NCHW (torch's ``F.grid_sample`` layout); the grid is
``(N, P, Q, 2)`` in [-1, 1] with x first.  Coordinates are unnormalised in
f32 (``(g + 1) * 0.5 * (size - 1)``, as ``grid_sample_pallas``) and handed
to K3 (``ops/kernels/grid_sample.py``), which launches the CUDA kernel for
CUDA tensors and takes its plain twin on the CPU.

``warp_const_src`` is the composed-warp loss's warp: an autograd Function
whose forward is K3 and whose backward is K4 (the coordinate gradient),
with no image gradient.
"""

from __future__ import annotations

import torch

from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear,
                                                   gather_bilinear_grad)
from dvd_tpu_torch.utils.dtypes import at_least_f32


def unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel coordinate, align_corners=True, in f32."""
    return (at_least_f32(coord) + 1.0) * 0.5 * (size - 1)


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
    out = gather_bilinear(at_least_f32(img).contiguous(), gx, gy,
                          padding_mode)
    return out.to(img.dtype)


def warp(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The reference's ``register_model2([img, grid])``: grid in [-1, 1],
    align_corners=True, zero padding."""
    return grid_sample(img, grid, padding_mode="zeros")


class _WarpConstSrc(torch.autograd.Function):
    """Zero-padded bilinear warp of a constant source: forward K3, backward
    K4 chained through the unnormalisation ``g = (grid + 1) * s`` with
    ``s = (size - 1) / 2``; the source gets no gradient."""

    @staticmethod
    def forward(ctx, img, grid):
        h, w = img.shape[-2:]
        src = at_least_f32(img.detach()).contiguous()
        gx = unnormalize(grid[..., 0].detach(), w).contiguous()
        gy = unnormalize(grid[..., 1].detach(), h).contiguous()
        ctx.save_for_backward(src, gx, gy)
        ctx.grid_dtype = grid.dtype
        return gather_bilinear(src, gx, gy, "zeros").to(img.dtype)

    @staticmethod
    def backward(ctx, ct):
        src, gx, gy = ctx.saved_tensors
        h, w = src.shape[-2:]
        ggx, ggy = gather_bilinear_grad(
            src, gx, gy, at_least_f32(ct).contiguous(), "zeros")
        gg = torch.stack([ggx * (0.5 * (w - 1)), ggy * (0.5 * (h - 1))], -1)
        return None, gg.to(ctx.grid_dtype)


def warp_const_src(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """:func:`warp` with ``img`` (N, C, H, W) treated as constant data: the
    gradient reaches ``grid`` (N, P, Q, 2) only (the composed-warp loss,
    reference ``gaussian_diffusion.py:999``, where the source is ground
    truth).  Port of ``dvd_tpu/ops/grid_sample.py:warp_const_src``."""
    if img.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2 \
            or grid.shape[0] != img.shape[0]:
        raise ValueError(f"bad shapes img={tuple(img.shape)} "
                         f"grid={tuple(grid.shape)}")
    return _WarpConstSrc.apply(img, grid)
