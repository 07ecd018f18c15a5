"""K3: bilinear gather and K4: its coordinate gradient
(``csrc/grid_sample.cu``), each beside its plain twin.

K3 replaces ``dvd_tpu/ops/pallas/grid_sample.py:gather_bilinear_planar``:
a planar image (N, C, H, W) f32 sampled at unnormalised pixel coordinates
``gx, gy`` (N, P, Q) f32 -> (N, C, P, Q) f32, align_corners=True
corner math, 'zeros' (per-corner validity) or 'border' padding.

K4 replaces ``gather_bilinear_grad_planar``: the gradient of K3's output
with respect to ``gx`` and ``gy``, contracted with an output cotangent
``ct`` (N, C, P, Q) over C -> two (N, P, Q) f32 planes; no image
gradient.  It is the backward of the composed-warp training loss
(``ops/grid_sample.py:warp_const_src``).

Unlike the TPU kernels, both take any shape.
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


def gather_bilinear_grad_ref(img: torch.Tensor, gx: torch.Tensor,
                             gy: torch.Tensor, ct: torch.Tensor,
                             padding_mode: str = "zeros"):
    """Plain twin of K4: the analytic weight derivatives of
    ``_gather_grad_kernel`` (``dwx = [-vx0, vx1]`` in 'zeros' mode,
    ``[-1, 1]`` in 'border'), contracted with ``ct`` over C."""
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
    xs, ys = (x0, x0 + 1), (y0, y0 + 1)
    wx, wy = [1 - tx, tx], [1 - ty, ty]
    one = torch.ones_like(tx)
    dwx, dwy = [-one, one], [-one, one]
    if padding_mode == "zeros":
        vx = [((xi >= 0) & (xi < w)).to(tx.dtype) for xi in xs]
        vy = [((yi >= 0) & (yi < h)).to(ty.dtype) for yi in ys]
        wx = [wx[i] * vx[i] for i in (0, 1)]
        wy = [wy[i] * vy[i] for i in (0, 1)]
        dwx, dwy = [-vx[0], vx[1]], [-vy[0], vy[1]]
    flat = img.reshape(n, c, h * w)
    sx = torch.zeros((n, c, p, q), dtype=img.dtype, device=img.device)
    sy = torch.zeros_like(sx)
    for dy in (0, 1):
        for dx in (0, 1):
            idx = (ys[dy].clamp(0, h - 1) * w + xs[dx].clamp(0, w - 1))
            vals = torch.gather(flat, 2, idx.reshape(n, 1, p * q)
                                .expand(n, c, p * q)).reshape(n, c, p, q)
            sx = sx + vals * (wy[dy] * dwx[dx])[:, None]
            sy = sy + vals * (dwy[dy] * wx[dx])[:, None]
    return (ct * sx).sum(1), (ct * sy).sum(1)


def _check(name, padding_mode, img, gx, gy, ct=None):
    """What K3's and K4's launches take: one CUDA device, f32, contiguous,
    an (N, C, H, W) image, (N, P, Q) coordinates and, for K4, an
    (N, C, P, Q) cotangent."""
    if padding_mode not in PADDING_MODES:
        raise NotImplementedError(padding_mode)
    tensors = [t for t in (img, gx, gy, ct) if t is not None]
    if not img.is_cuda or any(t.device != img.device for t in tensors):
        raise ValueError(f"{name}: inputs must share one CUDA device (got "
                         f"{[str(t.device) for t in tensors]})")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: inputs must be float32")
    if img.dim() != 4 or gx.dim() != 3 or gx.shape != gy.shape \
            or gx.shape[0] != img.shape[0] or (ct is not None and tuple(
                ct.shape) != tuple(img.shape[:2]) + tuple(gx.shape[1:])):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: the kernel takes no autograd "
                                  "inputs (warp_const_src is the Function)")


def gather_bilinear(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """(N, C, H, W) sampled at pixel coords (N, P, Q) -> (N, C, P, Q).
    CPU tensors take the plain twin; CUDA tensors launch K3 or raise."""
    if img.device.type == "cpu":
        return gather_bilinear_ref(img, gx, gy, padding_mode)
    _check("gather_bilinear", padding_mode, img, gx, gy)
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


def gather_bilinear_grad(img: torch.Tensor, gx: torch.Tensor,
                         gy: torch.Tensor, ct: torch.Tensor,
                         padding_mode: str = "zeros"):
    """(d/dgx, d/dgy) of sum(ct * gather_bilinear(img, gx, gy)), each
    (N, P, Q).  CPU tensors take the plain twin; CUDA tensors launch K4 or
    raise."""
    if img.device.type == "cpu":
        return gather_bilinear_grad_ref(img, gx, gy, ct, padding_mode)
    _check("gather_bilinear_grad", padding_mode, img, gx, gy, ct)
    n, c, h, w = img.shape
    _, p, q = gx.shape
    ggx = torch.empty((n, p, q), dtype=torch.float32, device=img.device)
    ggy = torch.empty_like(ggx)
    kl = build.load_library()
    err = kl.lib.dvd_gather_bilinear_grad(
        img.data_ptr(), gx.data_ptr(), gy.data_ptr(), ct.data_ptr(),
        ggx.data_ptr(), ggy.data_ptr(), n, c, h, w, p, q,
        int(padding_mode == "zeros"), build.stream_ptr(img))
    build.check_launch(kl, err, "dvd_gather_bilinear_grad")
    gather_bilinear_grad.launches += 1
    return ggx, ggy


gather_bilinear_grad.launches = 0
