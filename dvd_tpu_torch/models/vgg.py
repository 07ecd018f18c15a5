"""Pretrained-VGG16 feature pyramid (frozen aux net) and the DiT's and
UNet's c20 helpers (port of ``dvd_tpu/models/vgg.py``; reference
``train_settings/dvd/feature_backbones/VGG_features.py:15-72``).

torchvision VGG16 ``features`` split into blocks at the first ReLU, then at
each max pool:

- level_0: conv(3->64) + relu                        -> 64 ch  at full size
- level_1: conv(64->64) + relu + pool                -> 64 ch  at /2
- level_2: (conv + relu) x 2 (128) + pool            -> 128 ch at /4
- level_3: (conv + relu) x 3 (256) + pool            -> 256 ch at /8

Mode ``eigth`` returns [level_0, level_2, level_3], ``quarter`` [level_2],
any other mode all four; ``sixteen`` raises (the reference's branch reads
a level_4 its constructor never builds, as ``dvd_tpu`` notes).

Used when ``train_VGG=False``: the DiT takes ``c20_for_dit`` (256 ch at
the latent size, reference ``eval_utils.py:117-145``) in place of its
private pyramid.  The seven 3x3 convs run through K2 with ReLU in the
epilogue (scale 1, bias = the conv bias) in the input's dtype: f32, as
``dvd_tpu`` builds the module with its default dtype even in bf16
serving; the 2x2 max pools are plain torch.  NCHW.  Weights come from a
seed or a converted torchvision file (``training/convert.py:VGG16_RULES``,
``cli/convert_ckpt.py --kind vgg``) loaded with
``training/convert.load_variables``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.models.layers import conv3x3_folded
from dvd_tpu_torch.ops.resize import resize_bilinear

# (name, Cin, Cout, max pool after, a level ends after it)
VGG_LAYERS = (
    ("level_0_conv0", 3, 64, False, True),
    ("level_1_conv0", 64, 64, True, True),
    ("level_2_conv0", 64, 128, False, False),
    ("level_2_conv1", 128, 128, True, True),
    ("level_3_conv0", 128, 256, False, False),
    ("level_3_conv1", 256, 256, False, False),
    ("level_3_conv2", 256, 256, True, True),
)


class VGG16Pyramid(nn.Module):
    def __init__(self):
        super().__init__()
        for name, cin, cout, _, _ in VGG_LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, x: torch.Tensor, mode: str = "eigth"
                ) -> List[torch.Tensor]:
        """(N, 3, H, W) -> the levels ``mode`` selects (see the module
        docstring), NCHW in x's dtype."""
        if mode == "sixteen":
            raise NotImplementedError(
                "sixteen_resolution is unreachable dead code in the "
                "reference (VGG_features.py:39-40); not implemented")
        levels = []
        for name, _, _, pool, level_end in VGG_LAYERS:
            x = conv3x3_folded(getattr(self, name), None, x, True)
            if pool:
                x = F.max_pool2d(x, 2, 2)
            if level_end:
                levels.append(x)
        if mode == "eigth":
            return [levels[0], levels[2], levels[3]]
        if mode == "quarter":
            return [levels[2]]
        return levels


def c20_for_dit(feats: List[torch.Tensor], feature_size: int = 64
                ) -> torch.Tensor:
    """extract_raw_features_single2: the deepest ``eigth`` level (256 ch at
    /8), which must be the latent size."""
    if feats[-1].shape[-2] != feature_size:
        raise ValueError(f"VGG level 3 at {tuple(feats[-1].shape[-2:])}, "
                         f"the latent is {feature_size}")
    return feats[-1]


def c20_for_unet(feats: List[torch.Tensor], feature_size: int = 64
                 ) -> torch.Tensor:
    """extract_raw_features_single: the shallow 64-ch level resized to the
    latent size (align_corners=False)."""
    return resize_bilinear(feats[0], (feature_size, feature_size), False)
