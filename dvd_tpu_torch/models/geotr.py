"""GeoTrSegInf, mask branch only (port of the part of
``dvd_tpu/models/geotr.py:GeoTrSegInf`` that serving uses; reference
``geotr_core.py:997-1019``).

In the shipped config (``use_init_flow=False``) GeoTr's backward map is
dead; only the soft U2NetP mask, upsampled to ``mask_size``, reaches the
DiT (the ``mask_cat`` channel) -- what ``planar_aux.geotr_mask_planar``
computes on the TPU.  The flax variables' ``GeoTr`` subtree is listed as
skipped by the weight bridge; ``use_init_flow=True`` needs the full GeoTr,
which is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dvd_tpu_torch.models.u2net import U2NetP
from dvd_tpu_torch.ops.resize import resize_bilinear


class GeoTrSegInf(nn.Module):
    def __init__(self, mask_size: int = 512):
        super().__init__()
        self.mask_size = mask_size
        self.msk = U2NetP(3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, P, P) -> soft mask (N, 1, mask_size, mask_size)."""
        d0 = self.msk(x)[0]
        return resize_bilinear(d0, (self.mask_size, self.mask_size), True)
