"""Seeded stand-in document photos, made on the device in bulk: a light
page with dark, slightly tilted text lines on a darker background, with
noise (the pattern of ``chip_smoke.py``'s ``_page``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pages(n: int, h: int, w: int, gen: torch.Generator) -> torch.Tensor:
    """(n, h, w, 3) f32 in [0, 1] on the generator's device."""
    dev = gen.device
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device=dev),
                            torch.linspace(0, 1, w, device=dev),
                            indexing="ij")
    tilt = torch.rand((n, 1, 1), generator=gen, device=dev) * 0.1 - 0.05
    lines = torch.sin((yy + tilt * xx) * 60.0) > 0.8
    page = (xx > 0.08) & (xx < 0.92) & (yy > 0.06) & (yy < 0.94)
    img = 0.25 + 0.55 * page.float() - 0.45 * (lines & page).float()
    noise = 0.03 * torch.randn((n, h, w, 3), generator=gen, device=dev)
    return (img[..., None] + noise).clamp(0, 1)


def photo_u8(h: int, w: int, gen: torch.Generator) -> torch.Tensor:
    """One (h, w, 3) uint8 page on the generator's device."""
    return (pages(1, h, w, gen)[0] * 255).round().to(torch.uint8)


def source_of(page_u8: torch.Tensor, size: int) -> torch.Tensor:
    """The (size, size, 3) [0, 1] source of a uint8 page: a bilinear
    resize, standing in for the dataset's decode and resize."""
    x = page_u8.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False)
    return (x[0].permute(1, 2, 0) / 255.0).clamp(0, 1)
