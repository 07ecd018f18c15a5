"""K2: 'SAME' 3x3 conv with a fused f32 affine + ReLU epilogue and its
plain twin.

Replaces ``dvd_tpu/ops/pallas/planar_conv.py:conv3x3_planar``, keeping
its contract: ``y = act(conv(x, w) * scale + bias)`` with ``scale`` and
``bias`` per output channel in f32 (frozen BN folded in by the caller,
scale = 1 for plain convs), accumulation in f32, output in x's dtype.
Layout is NCHW, the TPU kernel's planar layout without the 128-lane pad.

CUDA tensors go by dtype, both to an implicit GEMM on the tensor cores:
bf16 to ``csrc/conv3x3_wgmma.cu`` (counted in ``conv3x3.launches_wgmma``),
f32 to ``csrc/conv3x3_f32x6.cu`` (``conv3x3.launches_f32``), which keeps
f32 accuracy with six bf16 products over a three-way bf16 split of each
operand (the TPU's ``precision=HIGHEST``); ``conv3x3.launches`` counts
both.  The kernels read the weights as a K-major copy: bf16
(:func:`k_major_weights`) or its three-way split
(:func:`k_major_weights_split`), which the frozen aux nets build once per
weight set in the fold cache (``models/layers.py:fold_conv_bn``) and other
callers per call.  A bf16 x's base must be 16-byte aligned (its
asynchronous copies).

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
# (csrc/conv3x3_wgmma.cu and csrc/conv3x3_f32x6.cu kMaxDilation)
MAX_DILATION = 32
# the kernels' code for an input they do not take
_NOT_TAKEN = -1


def chunk_channels(cin: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Input channels per chunk of the kernels' K axis (as
    ``chunk_channels`` in ``csrc/conv3x3_wgmma.cu`` and
    ``csrc/conv3x3_f32x6.cu``): 8 stacks two taps into each k16 step for
    the image-entry convs (Cin 3, 4), 16 for U2NetP's 16-channel layers,
    32 else in bf16; the f32 kernel's three weight planes take 16 at most."""
    if cin <= 8:
        return 8
    return 16 if cin <= 16 or dtype == torch.float32 else 32


def _chunk_k(cc: int) -> int:
    # columns per chunk: 9 taps x cc, padded to wgmma's k step of 16
    return -(-9 * cc // 16) * 16


def k_major_cols(cin: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Columns per output channel of the ``dtype`` kernel's K-major
    weights."""
    cc = chunk_channels(cin, dtype)
    return -(-cin // cc) * _chunk_k(cc)


def _k_major(w: torch.Tensor, cc: int) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (Cout, nchunks * KC) in w's dtype: Cin cut into
    chunks of ``cc`` (the last zero-padded), each chunk's columns tap-major
    (ky, kx) and channel-minor, zero-padded to KC, a multiple of 16
    (wgmma's k step)."""
    cout, cin = w.shape[:2]
    nch = -(-cin // cc)
    wp = F.pad(w, (0, 0, 0, 0, 0, nch * cc - cin))
    wk = wp.reshape(cout, nch, cc, 9).transpose(2, 3).reshape(cout, nch, 9 * cc)
    return F.pad(wk, (0, _chunk_k(cc) - 9 * cc)).reshape(cout, -1).contiguous()


def k_major_weights(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the bf16 kernel's weight operand (Cout,
    nchunks * KC) in bf16 (:func:`_k_major` at ``chunk_channels(Cin)``)."""
    return _k_major(w.to(torch.bfloat16), chunk_channels(w.shape[1]))


def split3_bf16(x: torch.Tensor):
    """f32 ``x`` as three bf16 tensors (h, m, l), each rounded to nearest:
    h = bf16(x), m = bf16(x - h), l = bf16(x - h - m).  Both differences
    are exact in f32, and h + m + l == x exactly for |x| in [2^-100,
    2^100] (24 significant bits in three of 8).  The f32 kernels split
    their operands so (``csrc/hopper.cuh:split3_pack``) and take a product
    a b as l h + h l + m m + m h + h m + h h of the parts."""
    h = x.to(torch.bfloat16)
    r = x - h.float()
    m = r.to(torch.bfloat16)
    return h, m, (r - m.float()).to(torch.bfloat16)


def k_major_weights_split(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the f32 kernel's weight operand (3, Cout,
    nchunks * KC) in bf16: the K-major f32 weights (:func:`_k_major` at
    ``chunk_channels(Cin, float32)``) split into planes h, m and l
    (:func:`split3_bf16`), which sum back to them exactly."""
    wk = _k_major(w.float(), chunk_channels(w.shape[1], torch.float32))
    return torch.stack(split3_bf16(wk)).contiguous()


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


# by dtype: the C entry, its planner, and the weight operand's builder
_ROUTES = {
    torch.float32: ("dvd_conv3x3_f32x6", "dvd_conv3x3_f32x6_plan",
                    k_major_weights_split),
    torch.bfloat16: ("dvd_conv3x3_wgmma", "dvd_conv3x3_wgmma_plan",
                     k_major_weights),
}


def _wk_shape(cin: int, cout: int, dtype: torch.dtype) -> tuple:
    cols = k_major_cols(cin, dtype)
    return (3, cout, cols) if dtype == torch.float32 else (cout, cols)


def conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, dilation: int = 1, relu: bool = True,
            wk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Cin, H, W) x (Cout, Cin, 3, 3) -> (B, Cout, H, W), padding =
    dilation.  CPU tensors take the plain twin; CUDA tensors launch K2 or
    raise.  ``wk``: the kernel's weight operand for a caller that keeps it
    (``k_major_weights(w)`` in bf16, ``k_major_weights_split(w)`` in f32;
    built here when None)."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, scale, bias, dilation, relu)
    dilation = int(dilation)
    _check(x, w, scale, bias, dilation)
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    entry, _, make_wk = _ROUTES[x.dtype]
    wk = make_wk(w) if wk is None else wk
    if (wk.dtype != torch.bfloat16 or wk.device != x.device
            or not wk.is_contiguous()
            or tuple(wk.shape) != _wk_shape(cin, cout, x.dtype)):
        raise ValueError(f"conv3x3: wk {tuple(wk.shape)} {wk.dtype} on "
                         f"{wk.device} is not {make_wk.__name__}(w)")
    out = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
    kl = build.load_library()
    err = getattr(kl.lib, entry)(
        x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, cin, cout, h, wd, dilation, int(bool(relu)),
        build.stream_ptr(x))
    if err == _NOT_TAKEN:
        raise ValueError(
            f"conv3x3: the {str(x.dtype)[6:]} kernel does not take x "
            f"{tuple(x.shape)} at byte offset {x.data_ptr() % 16} (bf16: "
            f"16-byte aligned bases), Cout {cout}, dilation {dilation}")
    build.check_launch(kl, err, entry)
    conv3x3.launches += 1
    if x.dtype == torch.float32:
        conv3x3.launches_f32 += 1
    else:
        conv3x3.launches_wgmma += 1
    return out


conv3x3.launches = 0
conv3x3.launches_wgmma = 0
conv3x3.launches_f32 = 0


def wgmma_plan(b: int, cin: int, cout: int, h: int, w: int,
               dilation: int = 1, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The ``dtype`` kernel's launch plan for these sizes (``*_plan`` in
    ``csrc/conv3x3_wgmma.cu`` and ``csrc/conv3x3_f32x6.cu``): output
    channels (bn) and input channels (cc) per block and chunk, m64 tiles
    per warpgroup (mt), the th x tw pixel tile, the copy width v in
    elements (1 in bf16: plain loads), dynamic shared memory per block,
    blocks in the grid and the K-major weights' columns."""
    out = (ctypes.c_longlong * 9)()
    kl = build.load_library()
    if getattr(kl.lib, _ROUTES[dtype][1])(b, cin, cout, h, w, int(dilation),
                                          ctypes.addressof(out)) != 0:
        raise ValueError(f"conv3x3: the {str(dtype)[6:]} kernel takes no "
                         f"{cin}->{cout} @{h}x{w} d{dilation} b{b}")
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
