"""K2: 'SAME' 3x3 conv with a fused f32 affine + ReLU epilogue
(``csrc/conv3x3.cu``) and its plain twin.

Replaces ``dvd_tpu/ops/pallas/planar_conv.py:conv3x3_planar``, keeping
its contract: ``y = act(conv(x, w) * scale + bias)`` with ``scale`` and
``bias`` per output channel in f32 (frozen BN folded in by the caller,
scale = 1 for plain convs), accumulation in f32, output in x's dtype.
Layout is NCHW, the TPU kernel's planar layout without the 128-lane pad.

``conv3x3_trainable`` is the autograd Function for trainable convs (the
DiT's conditioning pyramid): forward K2 on the live weights, backward
through ``torch.nn.grad.conv2d_input``/``conv2d_weight`` and a bias sum
(the JAX package computes this backward in XLA, outside any Pallas
kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dvd_tpu_torch.ops.kernels import build
from dvd_tpu_torch.utils.dtypes import at_least_f32

# the halo-padded input tile fills a block's shared memory at dilation 32
# (csrc/conv3x3.cu kMaxDilation)
MAX_DILATION = 32


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, dilation: int = 1,
                relu: bool = True) -> torch.Tensor:
    """Plain twin (``_conv3x3_planar_xla``): f32 conv of x and w (w rounded
    to x's dtype first), f32 affine, optional ReLU, cast to x's dtype."""
    d = int(dilation)
    y = F.conv2d(at_least_f32(x), at_least_f32(w.to(x.dtype)), None, 1, d, d)
    y = y * at_least_f32(scale)[None, :, None, None] \
        + at_least_f32(bias)[None, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, w, scale, bias, dilation):
    dev = x.device
    if not x.is_cuda or any(t.device != dev for t in (w, scale, bias)):
        raise ValueError("conv3x3: x, w, scale and bias must share one CUDA "
                         f"device (got {x.device}, {w.device}, {scale.device}, "
                         f"{bias.device})")
    if x.dtype not in build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3: x {x.dtype} and w {w.dtype} must match "
                        "and be float32 or bfloat16")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("conv3x3: scale and bias must be float32")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} w {tuple(w.shape)}")
    cout = w.shape[0]
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(f"conv3x3: scale {tuple(scale.shape)} bias "
                         f"{tuple(bias.shape)} for Cout {cout}")
    if not all(t.is_contiguous() for t in (x, w, scale, bias)):
        raise ValueError("conv3x3: inputs must be contiguous")
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"conv3x3: dilation {dilation} not in "
                         f"[1, {MAX_DILATION}]")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, bias)):
        raise NotImplementedError("conv3x3 takes no autograd inputs; "
                                  "conv3x3_trainable is the Function")


def conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, dilation: int = 1,
            relu: bool = True) -> torch.Tensor:
    """(B, Cin, H, W) x (Cout, Cin, 3, 3) -> (B, Cout, H, W), padding =
    dilation.  CPU tensors take the plain twin; CUDA tensors launch K2 or
    raise."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, scale, bias, dilation, relu)
    dilation = int(dilation)
    _check(x, w, scale, bias, dilation)
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    out = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
    kl = build.load_library()
    err = kl.lib.dvd_conv3x3(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, cin, cout, h, wd, dilation, int(bool(relu)),
        build.DTYPE_CODES[x.dtype], build.stream_ptr(x))
    build.check_launch(kl, err, "dvd_conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, dilation, relu):
        wc = w.to(x.dtype).contiguous()
        b = at_least_f32(bias).contiguous()
        y = conv3x3(x.contiguous(), wc, torch.ones_like(b), b, dilation, relu)
        ctx.save_for_backward(x, wc, y if relu else None)
        ctx.dilation, ctx.relu = dilation, relu
        ctx.dtypes = (w.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, wc, y = ctx.saved_tensors
        d = ctx.dilation
        with torch.autocast(x.device.type, enabled=False):
            g = g.to(x.dtype)
            if ctx.relu:
                g = g * (y > 0).to(g.dtype)
            gx = gw = gb = None
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, wc, g, padding=d,
                                                dilation=d)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, wc.shape, g, padding=d,
                                                 dilation=d).to(ctx.dtypes[0])
            if ctx.needs_input_grad[2]:
                gb = at_least_f32(g).sum((0, 2, 3)).to(ctx.dtypes[1])
        return gx, gw, gb, None, None


def conv3x3_trainable(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      dilation: int = 1, relu: bool = True) -> torch.Tensor:
    """``act(conv(x, w) + bias)`` through K2 with gradients for x, w and
    bias: w is cast to x's dtype (the compute dtype) for the kernel and
    its gradient returned in w's own dtype (the parameter dtype)."""
    return _Conv3x3.apply(x, w, bias, int(dilation), bool(relu))
