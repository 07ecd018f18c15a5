"""Text-line segmentation UNet, frozen aux net (port of
``dvd_tpu/models/textline_unet.py``; reference ``geotr/unet_model.py``).

Classic bilinear UNet with frozen BN.  Returns both the 64-channel
penultimate feature map (the ``line_msk`` conditioning input) and the
1-channel logits.  Every 3x3 conv runs through K2 with its bias and BN
folded into the epilogue; the ``up1`` DoubleConv takes Cin 1024.
Served, the forward replays a CUDA graph (``utils/graphs.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.models.layers import (BatchNorm, conv1x1_f32,
                                         conv3x3_folded)
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.utils import graphs


class DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, mid_ch: int = 0):
        super().__init__()
        mid = mid_ch or out_ch
        self.conv_0 = nn.Conv2d(in_ch, mid, 3, padding=1)
        self.bn_1 = BatchNorm(mid)
        self.conv_3 = nn.Conv2d(mid, out_ch, 3, padding=1)
        self.bn_4 = BatchNorm(out_ch)

    def forward(self, x):
        x = conv3x3_folded(self.conv_0, self.bn_1, x, True)
        return conv3x3_folded(self.conv_3, self.bn_4, x, True)


class TextLineUNet(nn.Module):
    """UNet(n_channels=3, n_classes=1, bilinear=True)."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.inc = DoubleConv(in_ch, 64)
        self.down1 = DoubleConv(64, 128)
        self.down2 = DoubleConv(128, 256)
        self.down3 = DoubleConv(256, 512)
        self.down4 = DoubleConv(512, 512)
        self.up1 = DoubleConv(1024, 256, 512)
        self.up2 = DoubleConv(512, 128, 256)
        self.up3 = DoubleConv(256, 64, 128)
        self.up4 = DoubleConv(128, 64, 64)
        self.outc = nn.Conv2d(64, 1, 1)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        # replayed from a CUDA graph where enabled (utils/graphs.py)
        return graphs.call(self, self._forward, x)

    def _forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        down = lambda y: F.max_pool2d(y, 2, 2)
        x1 = self.inc(x)
        x2 = self.down1(down(x1))
        x3 = self.down2(down(x2))
        x4 = self.down3(down(x3))
        y = self.down4(down(x4))
        for skip, name in ((x4, "up1"), (x3, "up2"), (x2, "up3"), (x1, "up4")):
            # (the reference pads on odd-size mismatch; sizes here are even)
            y = resize_bilinear(y, (y.shape[2] * 2, y.shape[3] * 2), True)
            y = getattr(self, name)(torch.cat([skip, y], 1))
        return y, conv1x1_f32(self.outc, y)
