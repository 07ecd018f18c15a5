"""Coordinate grids and the DvD flow conventions (port of
``dvd_tpu/utils/grids.py``).

- base grid: per-pixel normalised coordinates in [0, 1], x first;
- flow: the model's offset field, ``bm01 = flow + base``;
- sampling grid: ``(flow + base) * 2 - 1`` in [-1, 1], the
  ``grid_sample`` convention (x = width first).

Flows and grids are channel-last ``(..., H, W, 2)``, as in ``dvd_tpu`` and
as ``grid_sample`` takes its grid; ``nchw_to_nhwc`` and ``nhwc_to_nchw``
move images between the two layouts.
"""

from __future__ import annotations

import torch

# Load-bearing fudge factor for metric parity: the reference builds the
# final sampling grid as ((flow + base) * 2 - 1) * 0.987.
UNWARP_SHRINK = 0.987


def base_grid(h: int, w: int, dtype: torch.dtype = torch.float32,
              device=None) -> torch.Tensor:
    """Normalised [0, 1] coordinate grid of shape (h, w, 2), x first
    (linspace in float64, then cast, as ``dvd_tpu``)."""
    ys = torch.linspace(0.0, 1.0, h, dtype=torch.float64, device=device)
    xs = torch.linspace(0.0, 1.0, w, dtype=torch.float64, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1).to(dtype)


def flow_to_grid(flow: torch.Tensor, shrink: float = 1.0) -> torch.Tensor:
    """Offset field (..., H, W, 2) -> [-1, 1] sampling grid
    ``((flow + base) * 2 - 1) * shrink``."""
    h, w = flow.shape[-3], flow.shape[-2]
    g = (flow + base_grid(h, w, flow.dtype, flow.device)) * 2.0 - 1.0
    if shrink != 1.0:
        g = g * shrink
    return g


def grid_to_flow(grid: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`flow_to_grid` (with shrink 1)."""
    h, w = grid.shape[-3], grid.shape[-2]
    return (grid + 1.0) * 0.5 - base_grid(h, w, grid.dtype, grid.device)


def absolute_bm_to_flow(bm: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A backward map in pixels (x in 0..W-1, y in 0..H-1) -> the offset
    field: divided by (size - 1), as the training loop normalises its
    targets (reference ``train_util.py:306-312``)."""
    return bm / torch.tensor([w - 1.0, h - 1.0], dtype=bm.dtype,
                             device=bm.device)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)
