"""Bilinear grid sampling, ``align_corners=True`` (port of
``dvd_tpu/ops/grid_sample.py:grid_sample`` / ``warp``).

The image is NCHW (torch's ``F.grid_sample`` layout); the grid is
``(N, P, Q, 2)`` in [-1, 1] with x first.  Both go to K3's grid entry
(``ops/kernels/grid_sample.py:gather_bilinear_grid``), which unnormalises
the coordinates in f32 (``(g + 1) * 0.5 * (size - 1)``, as
``grid_sample_pallas``) inside the kernel for CUDA tensors and takes its
plain twin on the CPU.

``warp_const_src`` is the composed-warp loss's warp: an autograd Function
whose forward is K3 and whose backward is K4 (the coordinate gradient,
on the same grid), with no image gradient.
"""

from __future__ import annotations

import torch

from dvd_tpu_torch.ops.kernels.grid_sample import (  # noqa: F401
    gather_bilinear_grad, gather_bilinear_grid, unnormalize)
from dvd_tpu_torch.utils.dtypes import at_least_f32


def _check_shapes(img: torch.Tensor, grid: torch.Tensor) -> None:
    if img.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2 \
            or grid.shape[0] != img.shape[0]:
        raise ValueError(f"bad shapes img={tuple(img.shape)} "
                         f"grid={tuple(grid.shape)}")


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``img`` (N, C, H, W) at ``grid`` (N, P, Q, 2) -> (N, C, P, Q),
    bilinear, align_corners=True, 'zeros' or 'border' padding.  Computes in
    f32 and returns img's dtype."""
    _check_shapes(img, grid)
    out = gather_bilinear_grid(at_least_f32(img).contiguous(),
                               at_least_f32(grid).contiguous(), padding_mode)
    return out.to(img.dtype)


def warp(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The reference's ``register_model2([img, grid])``: grid in [-1, 1],
    align_corners=True, zero padding."""
    return grid_sample(img, grid, padding_mode="zeros")


class _WarpConstSrc(torch.autograd.Function):
    """Zero-padded bilinear warp of a constant source: forward K3, backward
    K4, both on the [-1, 1] grid (K4 applies the unnormalisation's factor
    ``(size - 1) / 2`` itself); the source gets no gradient."""

    @staticmethod
    def forward(ctx, img, grid):
        src = at_least_f32(img.detach()).contiguous()
        g = at_least_f32(grid.detach()).contiguous()
        ctx.save_for_backward(src, g)
        ctx.grid_dtype = grid.dtype
        return gather_bilinear_grid(src, g, "zeros").to(img.dtype)

    @staticmethod
    def backward(ctx, ct):
        src, g = ctx.saved_tensors
        gg = gather_bilinear_grad(src, g, at_least_f32(ct).contiguous(),
                                  "zeros")
        return None, gg.to(ctx.grid_dtype)


def warp_const_src(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """:func:`warp` with ``img`` (N, C, H, W) treated as constant data: the
    gradient reaches ``grid`` (N, P, Q, 2) only (the composed-warp loss,
    reference ``gaussian_diffusion.py:999``, where the source is ground
    truth).  Port of ``dvd_tpu/ops/grid_sample.py:warp_const_src``."""
    _check_shapes(img, grid)
    return _WarpConstSrc.apply(img, grid)
