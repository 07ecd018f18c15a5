"""K3: bilinear gather (``csrc/grid_sample.cu``) and its plain twin.

Replaces ``dvd_tpu/ops/pallas/grid_sample.py:gather_bilinear_planar``:
a planar image (N, C, H, W) f32 sampled at unnormalised pixel coordinates
``gx, gy`` (N, P, Q) f32 -> (N, C, P, Q) f32, align_corners=True
corner math, 'zeros' (per-corner validity) or 'border' padding.  Unlike
the TPU kernel it takes any shape.
"""

from __future__ import annotations

import torch

from dvd_tpu_torch.ops.kernels import build

PADDING_MODES = ("zeros", "border")


def gather_bilinear_ref(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                        padding_mode: str = "zeros") -> torch.Tensor:
    """Plain twin: the four-corner gather of ``dvd_tpu/ops/grid_sample.py``
    (same floor, corner order, weights and validity masks)."""
    if padding_mode not in PADDING_MODES:
        raise NotImplementedError(padding_mode)
    n, c, h, w = img.shape
    _, p, q = gx.shape
    x0f = torch.floor(gx)
    y0f = torch.floor(gy)
    tx = gx - x0f
    ty = gy - y0f
    x0 = x0f.clamp(-2, w).long()
    y0 = y0f.clamp(-2, h).long()
    flat = img.reshape(n, c, h * w)
    out = torch.zeros((n, c, p, q), dtype=img.dtype, device=img.device)
    for yi, xi, wgt in ((y0, x0, (1 - ty) * (1 - tx)),
                        (y0, x0 + 1, (1 - ty) * tx),
                        (y0 + 1, x0, ty * (1 - tx)),
                        (y0 + 1, x0 + 1, ty * tx)):
        if padding_mode == "zeros":
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            wgt = wgt * valid.to(wgt.dtype)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, p * q)
        vals = torch.gather(flat, 2, idx.expand(n, c, p * q))
        out = out + vals.reshape(n, c, p, q) * wgt[:, None]
    return out


def _check(img, gx, gy, padding_mode):
    if padding_mode not in PADDING_MODES:
        raise NotImplementedError(padding_mode)
    if not img.is_cuda or gx.device != img.device or gy.device != img.device:
        raise ValueError("gather_bilinear: img, gx and gy must share one CUDA "
                         f"device (got {img.device}, {gx.device}, {gy.device})")
    if any(t.dtype != torch.float32 for t in (img, gx, gy)):
        raise TypeError("gather_bilinear: img, gx and gy must be float32")
    if img.dim() != 4 or gx.dim() != 3 or gx.shape != gy.shape \
            or gx.shape[0] != img.shape[0]:
        raise ValueError(f"gather_bilinear: img {tuple(img.shape)} gx "
                         f"{tuple(gx.shape)} gy {tuple(gy.shape)}")
    if not all(t.is_contiguous() for t in (img, gx, gy)):
        raise ValueError("gather_bilinear: inputs must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (img, gx, gy)):
        raise NotImplementedError("gather_bilinear kernel is forward-only")


def gather_bilinear(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """(N, C, H, W) sampled at pixel coords (N, P, Q) -> (N, C, P, Q).
    CPU tensors take the plain twin; CUDA tensors launch K3 or raise."""
    if img.device.type == "cpu":
        return gather_bilinear_ref(img, gx, gy, padding_mode)
    _check(img, gx, gy, padding_mode)
    n, c, h, w = img.shape
    _, p, q = gx.shape
    out = torch.empty((n, c, p, q), dtype=torch.float32, device=img.device)
    kl = build.load_library()
    err = kl.lib.dvd_gather_bilinear(
        img.data_ptr(), gx.data_ptr(), gy.data_ptr(), out.data_ptr(),
        n, c, h, w, p, q, int(padding_mode == "zeros"), build.stream_ptr(img))
    build.check_launch(kl, err, "dvd_gather_bilinear")
    gather_bilinear.launches += 1
    return out


gather_bilinear.launches = 0
