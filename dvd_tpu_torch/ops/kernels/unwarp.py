"""The fused unwarp (``csrc/unwarp.cu``), K3's third entry, beside its plain
version.

One launch computes, per output pixel of a batch of NHWC pages, what the
JAX package builds around ``dvd_tpu/ops/pallas/grid_sample.py:
gather_bilinear_planar`` in ``dvd_tpu/evaluation/pipeline.py``
(``unwarp_native``, ``unwarp_fixed``): the flow upsampled to the page's
size, the grid ``((flow + base) * 2 - 1) * shrink``, (native) its mapping
into the canvas, the unnormalisation, the 'zeros' gather and the output
conversion.  The plain version is the composition the CPU runs:
:func:`native_grid` (or ``resize_bilinear`` + ``flow_to_grid`` for a page
at its own size), then K3's plain twin, then the uint8 rounding.  CUDA
tensors launch the kernel (counted in ``unwarp.launches``) or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from dvd_tpu_torch.ops.kernels import build
from dvd_tpu_torch.ops.kernels.grid_sample import (gather_bilinear_grid_ref,
                                                   gather_bilinear_ref,
                                                   unnormalize)
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.utils import trace
from dvd_tpu_torch.utils.grids import UNWARP_SHRINK, flow_to_grid

# channel counts with a kernel instance (gray, RGB, RGBA)
CHANNELS = (1, 3, 4)


def _upsample_axis(n_out: int, size: torch.Tensor, s: int):
    """Two-tap bilinear weights, align_corners=True with the border clamp,
    of an axis of ``s`` flow pixels upsampled to each image's ``size``
    (B,) samples, evaluated at the canvas positions 0..n_out-1: (i0, i1)
    int64 and (w0, w1) f32, each (B, n_out).  The taps and weights of
    ``dvd_tpu``'s per-image interpolation matrices, as lerps, not a
    matmul, so no TF32 or bf16 product can round the coordinates."""
    pos = torch.arange(n_out, dtype=torch.float32, device=size.device)[None]
    src = (pos * (s - 1.0) / (size[:, None] - 1.0)).clamp(0.0, s - 1.0)
    i0 = src.floor()
    frac = src - i0
    i0 = i0.long()
    return i0, (i0 + 1).clamp(max=s - 1), 1.0 - frac, frac


def native_grid(hw: torch.Tensor, flow: torch.Tensor, canvas: int,
                shrink: float = UNWARP_SHRINK):
    """The sampling grid of ``unwarp_native`` in canvas coordinates: two
    (B, P, P) f32 planes (x, y) in [-1, 1] of the (P, P) canvas.

    Per image of true size (h, w) = ``hw[b]``: the (S, S, 2) flow is
    upsampled to (h, w) separably (``dvd_tpu/evaluation/pipeline.py``
    :516-527), the grid ``((flow + base) * 2 - 1) * shrink`` is built on
    (h, w) (:529-532) and mapped from [-1, 1]-in-(h, w) into the canvas
    (:536-538).  Canvas pixels beyond (h, w) are don't-care."""
    flow = flow.to(torch.float32)
    b, s = flow.shape[:2]
    dev = flow.device
    h = hw[:, 0].to(dev, torch.float32)
    w = hw[:, 1].to(dev, torch.float32)
    batch = torch.arange(b, device=dev)[:, None]
    y0, y1, wy0, wy1 = _upsample_axis(canvas, h, s)
    x0, x1, wx0, wx1 = _upsample_axis(canvas, w, s)
    rows = (flow[batch, y0] * wy0[..., None, None]
            + flow[batch, y1] * wy1[..., None, None])        # (B, P, S, 2)
    bb = batch[:, :, None]
    flow_native = (rows[bb, torch.arange(canvas, device=dev)[None, :, None],
                        x0[:, None]] * wx0[:, None, :, None]
                   + rows[bb, torch.arange(canvas, device=dev)[None, :, None],
                          x1[:, None]] * wx1[:, None, :, None])  # (B, P, P, 2)
    del rows
    pos = torch.arange(canvas, dtype=torch.float32, device=dev)
    h, w = h[:, None, None], w[:, None, None]
    samp_x = ((flow_native[..., 0] + pos[None, None, :] / (w - 1.0))
              * 2.0 - 1.0) * shrink
    samp_y = ((flow_native[..., 1] + pos[None, :, None] / (h - 1.0))
              * 2.0 - 1.0) * shrink
    del flow_native
    px = (samp_x + 1.0) * (w - 1.0) / (canvas - 1.0) - 1.0
    py = (samp_y + 1.0) * (h - 1.0) / (canvas - 1.0) - 1.0
    return px, py


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """Round half to even (as ``jnp.round``), clip to [0, 255], cast."""
    return torch.round(img).clamp_(0.0, 255.0).to(torch.uint8)


def unwarp_ref(source: torch.Tensor, flow: torch.Tensor,
               hw: Optional[torch.Tensor] = None,
               shrink: float = UNWARP_SHRINK,
               out_u8: bool = False) -> torch.Tensor:
    """Plain version.  ``hw`` given (native): ``source`` (B, P, P, C) holds
    pages of sizes ``hw`` (B, 2) at the top left of a square canvas ->
    (B, P, P, C) f32 (uint8 with ``out_u8``).  ``hw`` None (fixed): the
    page is the whole (B, H, W, C) ``source`` -> (B, H, W, C) f32."""
    img = source.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    if hw is None:
        h, w = source.shape[1:3]
        flow_hw = resize_bilinear(
            flow.to(source.device, torch.float32).permute(0, 3, 1, 2),
            (h, w), True)
        grid = flow_to_grid(flow_hw.permute(0, 2, 3, 1), shrink)
        out = gather_bilinear_grid_ref(img, grid, "zeros")
    else:
        p = source.shape[1]
        px, py = native_grid(hw, flow.to(source.device), p, shrink)
        gx = unnormalize(px, p)
        del px
        gy = unnormalize(py, p)
        del py
        out = gather_bilinear_ref(img, gx, gy, "zeros")
    out = out.permute(0, 2, 3, 1)
    return to_u8(out) if out_u8 else out


def unwarp(source: torch.Tensor, flow: torch.Tensor,
           hw: Optional[torch.Tensor] = None, shrink: float = UNWARP_SHRINK,
           out_u8: bool = False) -> torch.Tensor:
    """The unwarp of :func:`unwarp_ref` (same arguments and results).  CPU
    tensors take the plain version; CUDA tensors launch the fused kernel
    or raise.  The kernel takes uint8 or f32 sources (others are cast to
    f32 first), C in ``CHANNELS``, any flow dtype (cast to f32).  The call
    is a ``dvd.unwarp`` span (``utils/trace.py``)."""
    with trace.span("dvd.unwarp", pages=source.shape[0]):
        return _unwarp(source, flow, hw, shrink, out_u8)


def _unwarp(source, flow, hw, shrink, out_u8):
    if source.device.type == "cpu":
        return unwarp_ref(source, flow, hw, shrink, out_u8)
    if not source.is_cuda:
        raise ValueError(f"unwarp: source on {source.device}; the kernel "
                         "takes a CUDA tensor")
    if source.dim() != 4 or source.shape[-1] not in CHANNELS \
            or flow.dim() != 4 or flow.shape[0] != source.shape[0] \
            or flow.shape[1] != flow.shape[2] or flow.shape[3] != 2:
        raise ValueError(f"unwarp: shapes source {tuple(source.shape)}, flow "
                         f"{tuple(flow.shape)} (C must be in {CHANNELS})")
    if hw is None and out_u8:
        raise ValueError("unwarp: the uint8 output is the native unwarp's")
    b, hc, wc, c = source.shape
    if hw is not None and (hc != wc or tuple(hw.shape) != (b, 2)):
        raise ValueError(f"unwarp: a native canvas is square with one (h, w) "
                         f"per page (source {tuple(source.shape)}, hw "
                         f"{tuple(hw.shape)})")
    if source.dtype not in (torch.uint8, torch.float32):
        source = source.float()
    source = source.contiguous()
    dev = source.device
    flow = flow.to(dev, torch.float32).contiguous()
    hw_dev = None if hw is None else hw.to(dev, torch.int32).contiguous()
    out = torch.empty((b, hc, wc, c),
                      dtype=torch.uint8 if out_u8 else torch.float32,
                      device=dev)
    vec = int(wc % 4 == 0 and source.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    kl = build.load_library()
    err = kl.lib.dvd_unwarp(
        source.data_ptr(), int(source.dtype == torch.uint8), flow.data_ptr(),
        0 if hw_dev is None else hw_dev.data_ptr(), out.data_ptr(),
        int(out_u8), int(hw is not None), b, hc, wc, c, flow.shape[1],
        float(shrink), vec, build.stream_ptr(source))
    build.check_launch(kl, err, "dvd_unwarp")
    unwarp.launches += 1
    return out


unwarp.launches = 0
