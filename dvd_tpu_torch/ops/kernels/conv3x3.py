"""K2: 'SAME' 3x3 conv with a fused f32 affine + ReLU epilogue and its
plain twin.

Replaces ``dvd_tpu/ops/pallas/planar_conv.py:conv3x3_planar``, keeping
its contract: ``y = act(conv(x, w) * scale + bias)`` with ``scale`` and
``bias`` per output channel in f32 (frozen BN folded in by the caller,
scale = 1 for plain convs), accumulation in f32, output in x's dtype.
Layout is NCHW, the TPU kernel's planar layout without the 128-lane pad.

CUDA tensors go by dtype: bf16 to the tensor-core implicit GEMM
(``csrc/conv3x3_wgmma.cu``, counted in ``conv3x3.launches_wgmma``), f32
to the CUDA-core direct conv (``csrc/conv3x3.cu``,
``conv3x3.launches_f32``); ``conv3x3.launches`` counts both.  The bf16
kernel reads the weights as a K-major copy (:func:`k_major_weights`),
which the frozen aux nets build once per weight set in the fold cache
(``models/layers.py:fold_conv_bn``) and other callers per call; x's base
must be 16-byte aligned (its asynchronous copies).

``conv3x3_trainable`` is the autograd Function for trainable convs (the
DiT's conditioning pyramid): forward K2 on the live weights, backward
through ``torch.nn.grad.conv2d_input``/``conv2d_weight`` and a bias sum
(the JAX package computes this backward in XLA, outside any Pallas
kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from dvd_tpu_torch.ops.kernels import build
from dvd_tpu_torch.utils.dtypes import at_least_f32

# the halo-padded input tile fills a block's shared memory at dilation 32
# (csrc/conv3x3.cu and csrc/conv3x3_wgmma.cu kMaxDilation)
MAX_DILATION = 32
# the bf16 kernel's code for an input it does not take
_NOT_TAKEN = -1


def chunk_channels(cin: int) -> int:
    """Input channels per chunk of the bf16 kernel's K axis (as
    ``csrc/conv3x3_wgmma.cu:chunk_channels``): 8 stacks two taps into each
    k16 step for the image-entry convs (Cin 3, 4), 16 for U2NetP's
    16-channel layers, 32 else."""
    return 8 if cin <= 8 else 16 if cin <= 16 else 32


def _chunk_k(cc: int) -> int:
    # columns per chunk: 9 taps x cc, padded to wgmma's k step of 16
    return -(-9 * cc // 16) * 16


def k_major_cols(cin: int) -> int:
    """Columns per output channel of :func:`k_major_weights`."""
    cc = chunk_channels(cin)
    return -(-cin // cc) * _chunk_k(cc)


def k_major_weights(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the bf16 kernel's weight operand (Cout,
    nchunks * KC) in bf16: Cin cut into chunks of ``chunk_channels(Cin)``
    (the last zero-padded), each chunk's columns tap-major (ky, kx) and
    channel-minor, zero-padded to KC, a multiple of 16 (wgmma's k step)."""
    cout, cin = w.shape[:2]
    cc = chunk_channels(cin)
    nch = -(-cin // cc)
    kc = _chunk_k(cc)
    wp = F.pad(w.to(torch.bfloat16), (0, 0, 0, 0, 0, nch * cc - cin))
    wk = wp.reshape(cout, nch, cc, 9).transpose(2, 3).reshape(cout, nch, 9 * cc)
    return F.pad(wk, (0, kc - 9 * cc)).reshape(cout, nch * kc).contiguous()


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
            bias: torch.Tensor, dilation: int = 1, relu: bool = True,
            wk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Cin, H, W) x (Cout, Cin, 3, 3) -> (B, Cout, H, W), padding =
    dilation.  CPU tensors take the plain twin; CUDA tensors launch K2 or
    raise.  ``wk``: ``k_major_weights(w)``, for a caller that keeps it
    (bf16 only; built here when None)."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, scale, bias, dilation, relu)
    dilation = int(dilation)
    _check(x, w, scale, bias, dilation)
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    out = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
    kl = build.load_library()
    if x.dtype == torch.float32:
        err = kl.lib.dvd_conv3x3(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, cin, cout, h, wd, dilation, int(bool(relu)),
            build.DTYPE_CODES[x.dtype], build.stream_ptr(x))
        build.check_launch(kl, err, "dvd_conv3x3")
        conv3x3.launches_f32 += 1
    else:
        wk = k_major_weights(w) if wk is None else wk
        if (wk.dtype != torch.bfloat16 or wk.device != x.device
                or not wk.is_contiguous()
                or tuple(wk.shape) != (cout, k_major_cols(cin))):
            raise ValueError(f"conv3x3: wk {tuple(wk.shape)} {wk.dtype} on "
                             f"{wk.device} is not k_major_weights(w)")
        err = kl.lib.dvd_conv3x3_wgmma(
            x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, cin, cout, h, wd, dilation, int(bool(relu)),
            build.stream_ptr(x))
        if err == _NOT_TAKEN:
            raise ValueError(
                f"conv3x3: the bf16 kernel does not take x {tuple(x.shape)} "
                f"at byte offset {x.data_ptr() % 16} (16-byte aligned bases), "
                f"Cout {cout}, dilation {dilation}")
        build.check_launch(kl, err, "dvd_conv3x3_wgmma")
        conv3x3.launches_wgmma += 1
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
conv3x3.launches_wgmma = 0
conv3x3.launches_f32 = 0


def wgmma_plan(b: int, cin: int, cout: int, h: int, w: int,
               dilation: int = 1) -> dict:
    """The bf16 kernel's launch plan for these sizes
    (``csrc/conv3x3_wgmma.cu:dvd_conv3x3_wgmma_plan``): output channels
    (bn) and input channels (cc) per block and chunk, m64 tiles per
    warpgroup (mt), the th x tw pixel tile, the copy width v in elements
    (1: plain loads), dynamic shared memory per block, blocks in the grid
    and the K-major weights' columns."""
    out = (ctypes.c_longlong * 9)()
    kl = build.load_library()
    if kl.lib.dvd_conv3x3_wgmma_plan(b, cin, cout, h, w, int(dilation),
                                     ctypes.addressof(out)) != 0:
        raise ValueError(f"conv3x3: the bf16 kernel takes no {cin}->{cout} "
                         f"@{h}x{w} d{dilation} b{b}")
    return dict(zip(("bn", "cc", "mt", "th", "tw", "v", "smem", "blocks",
                     "k_cols"), out))


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
