"""Coordinate grids and the DvD flow conventions (port of
``dvd_tpu/utils/grids.py``).

- base grid: per-pixel normalised coordinates in [0, 1], x first;
- flow: the model's offset field, ``bm01 = flow + base``;
- sampling grid: ``(flow + base) * 2 - 1`` in [-1, 1], the
  ``grid_sample`` convention (x = width first).

Flows and grids are channel-last ``(..., H, W, 2)``, as in ``dvd_tpu`` and
as ``grid_sample`` takes its grid.
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
