"""K3: bilinear gather and K4: its coordinate gradient
(``csrc/grid_sample.cu``), each beside its plain twin.

K3 replaces ``dvd_tpu/ops/pallas/grid_sample.py:gather_bilinear_planar``:
a planar image (N, C, H, W) f32 sampled at N x P x Q points -> (N, C, P, Q)
f32, align_corners=True corner math, 'zeros' (per-corner validity) or
'border' padding.  It has two entries into one kernel body:

- :func:`gather_bilinear_grid` takes the [-1, 1] grid (N, P, Q, 2) and
  unnormalises it inside the kernel (``grid_sample``, ``warp``,
  ``warp_const_src``);
- :func:`gather_bilinear` takes the unnormalised pixel coordinates
  ``gx, gy`` (N, P, Q), the Pallas kernel's own contract.

Each entry counts its launches in its own ``launches``.  The fused unwarp
(``ops/kernels/unwarp.py``) is K3's third entry, a kernel of its own.

K4 replaces ``gather_bilinear_grad_planar``: the gradient of
``sum(ct * K3(img, grid))`` with respect to the [-1, 1] grid, (N, P, Q, 2),
for a cotangent ``ct`` (N, C, P, Q); no image gradient.  It is the
backward of the composed-warp training loss
(``ops/grid_sample.py:warp_const_src``).

Unlike the TPU kernels, both take any shape.
"""

from __future__ import annotations

import ctypes

import torch

from dvd_tpu_torch.ops.kernels import build
from dvd_tpu_torch.utils.dtypes import at_least_f32

PADDING_MODES = ("zeros", "border")


def unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel coordinate, align_corners=True, in f32."""
    return (at_least_f32(coord) + 1.0) * 0.5 * (size - 1)


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


def gather_bilinear_grid_ref(img: torch.Tensor, grid: torch.Tensor,
                             padding_mode: str = "zeros") -> torch.Tensor:
    """Plain twin of K3's grid entry: the grid unnormalised in f32, then
    :func:`gather_bilinear_ref`."""
    h, w = img.shape[-2:]
    return gather_bilinear_ref(img, unnormalize(grid[..., 0], w),
                               unnormalize(grid[..., 1], h), padding_mode)


def gather_bilinear_grad_ref(img: torch.Tensor, gx: torch.Tensor,
                             gy: torch.Tensor, ct: torch.Tensor,
                             padding_mode: str = "zeros"):
    """Plain twin of K4's contract at pixel coordinates: the analytic weight
    derivatives of ``_gather_grad_kernel`` (``dwx = [-vx0, vx1]`` in 'zeros'
    mode, ``[-1, 1]`` in 'border'), contracted with ``ct`` over C -> the
    (N, P, Q) planes d/dgx and d/dgy."""
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


def gather_bilinear_grad_grid_ref(img: torch.Tensor, grid: torch.Tensor,
                                  ct: torch.Tensor,
                                  padding_mode: str = "zeros") -> torch.Tensor:
    """Plain twin of K4 on the grid: :func:`gather_bilinear_grad_ref` at the
    unnormalised grid, chained through ``g = (grid + 1) * 0.5 * (size - 1)``
    -> (N, P, Q, 2)."""
    h, w = img.shape[-2:]
    ggx, ggy = gather_bilinear_grad_ref(
        img, unnormalize(grid[..., 0], w), unnormalize(grid[..., 1], h), ct,
        padding_mode)
    return torch.stack([ggx * (0.5 * (w - 1)), ggy * (0.5 * (h - 1))], -1)


def _check(name, padding_mode, img, coords, ct=None):
    """What K3's and K4's launches take: one CUDA device, f32, contiguous,
    an (N, C, H, W) image, coordinates (the (N, P, Q, 2) grid, or two
    (N, P, Q) planes) and, for K4, an (N, C, P, Q) cotangent."""
    if padding_mode not in PADDING_MODES:
        raise NotImplementedError(padding_mode)
    tensors = [img, *coords] + ([ct] if ct is not None else [])
    if not img.is_cuda or any(t.device != img.device for t in tensors):
        raise ValueError(f"{name}: inputs must share one CUDA device (got "
                         f"{[str(t.device) for t in tensors]})")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: inputs must be float32")
    if len(coords) == 1:
        ok = coords[0].dim() == 4 and coords[0].shape[-1] == 2
    else:
        ok = coords[0].dim() == 3 and coords[0].shape == coords[1].shape
    npq = tuple(coords[0].shape[:3])
    ok = ok and img.dim() == 4 and npq[0] == img.shape[0] and (
        ct is None or tuple(ct.shape) == (*img.shape[:2], *npq[1:]))
    if not ok:
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: the kernel takes no autograd "
                                  "inputs (warp_const_src is the Function)")


def _vec(pq: int, *tensors) -> int:
    """1 when the kernel may move whole vectors: P * Q a multiple of 4 and
    every base pointer 16-byte aligned."""
    return int(pq % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch_gather(img, ca, cb, padding_mode, grid: bool) -> torch.Tensor:
    n, c, h, w = img.shape
    p, q = ca.shape[1:3]
    out = torch.empty((n, c, p, q), dtype=torch.float32, device=img.device)
    kl = build.load_library()
    err = kl.lib.dvd_gather_bilinear(
        img.data_ptr(), ca.data_ptr(), cb.data_ptr(), out.data_ptr(),
        n, c, h, w, p, q, int(padding_mode == "zeros"), int(grid),
        _vec(p * q, img, ca, cb, out), build.stream_ptr(img))
    build.check_launch(kl, err, "dvd_gather_bilinear")
    return out


def gather_bilinear(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """(N, C, H, W) sampled at pixel coords (N, P, Q) -> (N, C, P, Q).
    CPU tensors take the plain twin; CUDA tensors launch K3 or raise."""
    if img.device.type == "cpu":
        return gather_bilinear_ref(img, gx, gy, padding_mode)
    _check("gather_bilinear", padding_mode, img, (gx, gy))
    out = _launch_gather(img, gx, gy, padding_mode, grid=False)
    gather_bilinear.launches += 1
    return out


def gather_bilinear_grid(img: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "zeros") -> torch.Tensor:
    """(N, C, H, W) sampled at the [-1, 1] grid (N, P, Q, 2), x first ->
    (N, C, P, Q).  CPU tensors take the plain twin; CUDA tensors launch K3
    or raise."""
    if img.device.type == "cpu":
        return gather_bilinear_grid_ref(img, grid, padding_mode)
    _check("gather_bilinear_grid", padding_mode, img, (grid,))
    out = _launch_gather(img, grid, grid, padding_mode, grid=True)
    gather_bilinear_grid.launches += 1
    return out


gather_bilinear.launches = 0
gather_bilinear_grid.launches = 0


def gather_plan(n: int, c: int, pq: int) -> dict:
    """K3's launch plan for (N, C, P * Q): channels per thread ``g``,
    points per thread ``pix``, channel ``groups`` and ``blocks`` along the
    points."""
    out = (ctypes.c_int * 4)()
    build.load_library().lib.dvd_gather_bilinear_plan(n, c, pq, out)
    return dict(zip(("g", "pix", "groups", "blocks"), out))


def gather_bilinear_grad(img: torch.Tensor, grid: torch.Tensor,
                         ct: torch.Tensor,
                         padding_mode: str = "zeros") -> torch.Tensor:
    """d/dgrid of sum(ct * gather_bilinear_grid(img, grid)), (N, P, Q, 2).
    CPU tensors take the plain twin; CUDA tensors launch K4 or raise."""
    if img.device.type == "cpu":
        return gather_bilinear_grad_grid_ref(img, grid, ct, padding_mode)
    _check("gather_bilinear_grad", padding_mode, img, (grid,), ct)
    n, c, h, w = img.shape
    p, q = grid.shape[1:3]
    gg = torch.empty((n, p, q, 2), dtype=torch.float32, device=img.device)
    kl = build.load_library()
    err = kl.lib.dvd_gather_bilinear_grad(
        img.data_ptr(), grid.data_ptr(), ct.data_ptr(), gg.data_ptr(),
        n, c, h, w, p, q, int(padding_mode == "zeros"),
        _vec(p * q, img, grid, ct, gg), build.stream_ptr(img))
    build.check_launch(kl, err, "dvd_gather_bilinear_grad")
    gather_bilinear_grad.launches += 1
    return gg


gather_bilinear_grad.launches = 0
