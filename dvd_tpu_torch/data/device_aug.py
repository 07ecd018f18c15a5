"""On-device training augmentation (port of ``dvd_tpu/data/device_aug.py``).

The Doc3D datasets' ``device_aug`` mode ships the decoded, cropped and
background-composited 512^2 image, its soft mask and the backward map
(``image512``, ``doc_mask512``, ``flow_map``); this module finishes the
augmentation on the training device, in the batch preparation: the
intermediate warp (reference ``listdataset.py:625-646``) and the colour
jitter (``:647``).

- The warp of image and mask is one launch of K3's grid entry
  (``ops/grid_sample.py:warp``) over the (B, 4, H, W) stack of the three
  image channels and the mask: the channel-last batch is copied to NCHW
  anyway, a stack of four is one channel group of the kernel, and the
  grid is read once instead of twice.  Each channel's arithmetic is the
  one two launches would do.
- The jitter applies the four ops in ``dvd_tpu``'s fixed order
  (brightness, contrast, saturation, hue) with per-sample factors.
  Drawing the factors (:func:`jitter_factors`, from an explicit
  ``torch.Generator``) is split from applying them, so a caller can hand
  in factors drawn elsewhere.
- Everything runs in f32 whatever the model's compute dtype, as in
  ``dvd_tpu``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dvd_tpu_torch.ops.grid_sample import warp

LUMA = (0.299, 0.587, 0.114)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Channel-last RGB in [0, 1] -> HSV with h in [0, 1)."""
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    safe = torch.where(d > 0, d, torch.ones_like(d))
    # the select order matters where two channels tie for the maximum
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    # floor-mod (torch.remainder), never fmod: negative hues wrap to [0, 1)
    h = torch.where(d > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    # h rounded up to 1.0 gives i = 6: it wraps to sector 0
    i = torch.remainder(i.to(torch.int32), 6)
    sectors = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
               (v, p, q))
    out = []
    for c in range(3):
        x = sectors[5][c]
        for k in range(4, -1, -1):
            x = torch.where(i == k, sectors[k][c], x)
        out.append(x)
    return torch.stack(out, dim=-1)


def jitter_factors(b: int, generator: torch.Generator, strength: float = 0.1
                   ) -> Tuple[torch.Tensor, ...]:
    """Per-sample (brightness, contrast, saturation, hue) factors, (B,) f32
    each, uniform in [1 - s, 1 + s] (hue in [-s, s]), drawn in that order
    from ``generator`` on its device."""
    def u(lo, hi):
        x = torch.rand((b,), generator=generator, device=generator.device)
        return lo + (hi - lo) * x

    lo, hi = 1.0 - strength, 1.0 + strength
    return u(lo, hi), u(lo, hi), u(lo, hi), u(-strength, strength)


def apply_color_jitter(img: torch.Tensor, bright: torch.Tensor,
                       contrast: torch.Tensor, sat: torch.Tensor,
                       hue: torch.Tensor) -> torch.Tensor:
    """The four jitter ops at given per-sample factors (B,) on ``img``
    (B, H, W, 3) in [0, 1]: brightness scale, contrast about the sample's
    mean over (H, W, C), luma-mix saturation, hue rotation in turns."""
    def e(f):
        return f.to(img.dtype)[:, None, None, None]

    img = img * e(bright)
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = (img - mean) * e(contrast) + mean
    r, g, b = img.unbind(-1)
    gray = r * LUMA[0] + g * LUMA[1] + b * LUMA[2]
    img = img * e(sat) + gray[..., None] * (1.0 - e(sat))
    hsv = rgb_to_hsv(img.clamp(0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + hue.to(img.dtype)[:, None, None], 1.0)
    img = hsv_to_rgb(torch.cat([h[..., None], hsv[..., 1:]], dim=-1))
    return img.clamp(0.0, 1.0)


def inter_grid(flow: torch.Tensor, inter_frac: float) -> torch.Tensor:
    """The intermediate warp's [-1, 1] sampling grid (B, H, W, 2) from the
    absolute backward-map offsets ``flow`` (B, H, W, 2):
    ``base + 2 * frac * flow / (H - 1)``.

    The base is ``jnp.linspace(-1, 1, H, dtype=float32)`` as ``dvd_tpu``'s
    jitted batch preparation computes it: ``-(1 - i * r) + i * r`` with
    ``r = 1 / (H - 1)``, each step rounded to f32, and 1 at the end.  It
    is built on the CPU, one op at a time, so no device contracts a
    multiply-add into an FMA (an eager ``jnp.linspace`` call does, and
    moves a third of the points by an ulp).  ``base + c * flow`` is
    rounded once, as the multiply-add that XLA's fusion contracts there
    (in f64, then to f32): rounded twice, a point moves by an ulp, which
    moves a sample of a noise image by up to 1.5e-5."""
    h = flow.shape[1]
    ir = torch.arange(h - 1, dtype=torch.float32) \
        * (torch.ones((), dtype=torch.float32) / (h - 1))
    xs = torch.cat([-(1.0 - ir) + ir, torch.ones(1)]).to(flow.device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    base = torch.stack([gx, gy], dim=-1).double()
    c = float(torch.tensor(2.0 * inter_frac / (h - 1.0), dtype=torch.float32))
    return (base[None] + c * flow.double()).float()


def augment_batch(raw: Dict[str, torch.Tensor],
                  factors: Optional[Tuple[torch.Tensor, ...]] = None, *,
                  inter_frac: float = 0.0) -> Dict[str, torch.Tensor]:
    """The device half of the Doc3D augmentation.

    raw: ``image512`` (B, H, W, 3) in [0, 255], ``doc_mask512``
    (B, H, W, 1) in [0, 1], ``flow_map`` (B, H, W, 2) absolute backward-map
    offsets (pixels).  ``factors``: the jitter's four (B,) factors
    (:func:`jitter_factors`), or None for no jitter.  Returns the float
    wire that ``training.train_loop.build_device_batch`` takes:
    ``source_image`` (B, H, W, 3) in [0, 1], ``doc_mask`` (B, H, W, 1),
    ``flow_map`` and ``flow_map_inter = inter_frac * flow_map``, all f32
    and channel-last (the images as views of NCHW tensors)."""
    flow = raw["flow_map"].float()
    img = raw["image512"].float() / 255.0
    stack = torch.cat([img, raw["doc_mask512"].float()], dim=-1)
    out = warp(stack.permute(0, 3, 1, 2).contiguous(),
               inter_grid(flow, inter_frac)).permute(0, 2, 3, 1)
    src, msk = out[..., :3], out[..., 3:]
    if factors is not None:
        src = apply_color_jitter(src, *factors)
    return {"source_image": src, "doc_mask": msk, "flow_map": flow,
            "flow_map_inter": inter_frac * flow}
