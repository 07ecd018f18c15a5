"""U^2-Net-small document segmentation (frozen aux net) and its Seg
wrapper (port of ``dvd_tpu/models/u2net.py``; reference
``geotr_core.py:24-332,846-995``).

NCHW throughout: torch's layout is the TPU package's "planar" layout
without the 128-lane pad, so this one module set replaces both the NHWC
flax modules and ``dvd_tpu/models/planar_aux.py``.  Every REBNCONV and
side conv runs through K2 with the conv bias and the frozen BN folded into
its f32 (scale, bias) epilogue; the fold is computed once per loaded
weight set (``layers.fold_conv_bn``), not per call.  Served, U2NetP's
forward replays a CUDA graph (``utils/graphs.py``).
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


def max_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool, ceil mode (odd edges see only their valid pixels)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def upsample_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(src, tuple(tar.shape[-2:]), align_corners=False)


class REBNCONV(nn.Module):
    """3x3 dilated conv + frozen BN + ReLU, one K2 launch."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate,
                                 dilation=dirate)
        self.bn_s1 = BatchNorm(out_ch)

    def forward(self, x):
        return conv3x3_folded(self.conv_s1, self.bn_s1, x, True)


class RSU(nn.Module):
    """RSU-L block: L encoder levels with ceil pooling, a dilated
    bottleneck, a skip-connected decoder, residual to the input conv."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2))
        for i in range(height - 1, 0, -1):
            setattr(self, f"rebnconv{i}d",
                    REBNCONV(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x):
        hxin = self.rebnconvin(x)
        enc = [self.rebnconv1(hxin)]
        h = enc[0]
        for i in range(2, self.height):
            h = getattr(self, f"rebnconv{i}")(max_pool_ceil(h))
            enc.append(h)
        d = getattr(self, f"rebnconv{self.height}")(enc[-1])
        for i in range(self.height - 1, 0, -1):
            d = getattr(self, f"rebnconv{i}d")(torch.cat([d, enc[i - 1]], 1))
            if i > 1:
                d = upsample_like(d, enc[i - 2])
        return d + hxin


class RSU4F(nn.Module):
    """Dilation-only RSU (no pooling), dilations 1/2/4/8."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat([h4, h3], 1))
        d2 = self.rebnconv2d(torch.cat([d3, h2], 1))
        return self.rebnconv1d(torch.cat([d2, h1], 1)) + hxin


class U2NetP(nn.Module):
    """U^2-Net small.  Returns (sigmoid(d0), hx6, hx5d, hx4d, hx3d, hx2d,
    hx1d), NCHW, in the input's dtype."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1):
        super().__init__()
        self.stage1 = RSU(7, in_ch, 16, 64)
        self.stage2 = RSU(6, 64, 16, 64)
        self.stage3 = RSU(5, 64, 16, 64)
        self.stage4 = RSU(4, 64, 16, 64)
        self.stage5 = RSU4F(64, 16, 64)
        self.stage6 = RSU4F(64, 16, 64)
        self.stage5d = RSU4F(128, 16, 64)
        self.stage4d = RSU(4, 128, 16, 64)
        self.stage3d = RSU(5, 128, 16, 64)
        self.stage2d = RSU(6, 128, 16, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i in range(1, 7):
            setattr(self, f"side{i}", nn.Conv2d(64, out_ch, 3, padding=1))
        self.outconv = nn.Conv2d(6 * out_ch, out_ch, 1)

    def forward(self, x):
        # replayed from a CUDA graph where enabled (utils/graphs.py)
        return graphs.call(self, self._forward, x)

    def _forward(self, x):
        s1 = self.stage1(x)
        s2 = self.stage2(max_pool_ceil(s1))
        s3 = self.stage3(max_pool_ceil(s2))
        s4 = self.stage4(max_pool_ceil(s3))
        s5 = self.stage5(max_pool_ceil(s4))
        s6 = self.stage6(max_pool_ceil(s5))
        d5 = self.stage5d(torch.cat([upsample_like(s6, s5), s5], 1))
        d4 = self.stage4d(torch.cat([upsample_like(d5, s4), s4], 1))
        d3 = self.stage3d(torch.cat([upsample_like(d4, s3), s3], 1))
        d2 = self.stage2d(torch.cat([upsample_like(d3, s2), s2], 1))
        d1 = self.stage1d(torch.cat([upsample_like(d2, s1), s1], 1))
        sides = [conv3x3_folded(getattr(self, f"side{i}"), None, d, False)
                 for i, d in enumerate((d1, d2, d3, d4, d5, s6), start=1)]
        sides = [sides[0]] + [upsample_like(o, s1) for o in sides[1:]]
        d0 = torch.sigmoid(conv1x1_f32(self.outconv, torch.cat(sides, 1))
                           .float()).to(x.dtype)
        return d0, s6, d5, d4, d3, d2, d1


class Seg(nn.Module):
    """Seg wrapper (reference ``geotr_core.py:984-995``): hard-masks the
    image at 0.5, upsamples the soft mask to ``mask_size``, and returns the
    six decoder side features for the ``seg_map_all`` conditioning."""

    def __init__(self, mask_size: int = 512):
        super().__init__()
        self.mask_size = mask_size
        self.msk = U2NetP(3, 1)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
        d0, *pyramid = self.msk(x)
        mskx = (d0 > 0.5).to(x.dtype) * x
        d0_up = resize_bilinear(d0, (self.mask_size, self.mask_size), True)
        return mskx, d0_up, tuple(pyramid)


def seg_pyramid_to_latent(feats, latent_size: int) -> torch.Tensor:
    """Resize the six side features (hx6..hx1d) to the latent size
    (align_corners=False) and concatenate -> (N, 384, S, S)."""
    size = (latent_size, latent_size)
    return torch.cat([resize_bilinear(f, size, False) for f in feats], 1)
