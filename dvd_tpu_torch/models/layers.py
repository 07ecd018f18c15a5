"""Shared building blocks (port of ``dvd_tpu/models/layers.py``).

Module and parameter names follow the flax parameter paths, so a flax
variable tree maps onto a state_dict by name (``training/convert.py``):
a flax ``kernel`` becomes ``weight`` (Dense (in, out) -> (out, in), Conv
HWIO -> OIHW); every other leaf keeps its name (``bias``; norm ``scale``;
BN ``mean``/``var``).  Images are NCHW, tokens (N, T, D).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.ops.kernels.attention import attention
from dvd_tpu_torch.ops.kernels.conv3x3 import (conv3x3, conv3x3_trainable,
                                               k_major_weights,
                                               k_major_weights_split)
from dvd_tpu_torch.ops.quant import qlinear, quantize_rows
from dvd_tpu_torch.parallel import comm
from dvd_tpu_torch.utils.dtypes import at_least_f32


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation ``x * (1 + scale) + shift`` with (N, D) conditioners."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, statistics in f32, result in x's dtype."""
    return F.layer_norm(at_least_f32(x), (x.shape[-1],), eps=eps).to(x.dtype)


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """(N, H, Tq, Dh) x (N, H, Tk, Dh) attention, softmax in f32: K1 on a
    card, its plain twin on the CPU."""
    return attention(q, k, v, scale)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(N, T, D) -> (N, H, T, D/H), a strided view (no copy)."""
    n, t, d = x.shape
    return x.view(n, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    n, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(n, t, h * dh)


class SelfAttention(nn.Module):
    """timm-style fused-QKV self attention (qkv_bias=True); with ``quant``
    the projections are W8A8 (``ops/quant.py``)."""

    def __init__(self, dim: int, num_heads: int, quant: bool = False):
        super().__init__()
        self.num_heads, self.quant = num_heads, quant
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = project(self.qkv, x, self.quant).chunk(3, dim=-1)
        h = self.num_heads
        out = scaled_dot_attention(split_heads(q, h), split_heads(k, h),
                                   split_heads(v, h))
        return project(self.proj, merge_heads(out), self.quant)


def project(layer: nn.Module, x: torch.Tensor, quant: bool,
            prequant=None) -> torch.Tensor:
    """``layer(x)``, or with ``quant`` its W8A8 route (``ops/quant.py``;
    ``prequant``: the input's shared ``quantize_rows``)."""
    return qlinear(layer, x, prequant) if quant else layer(x)


def shared_prequant(query, key, value):
    """``quantize_rows`` of each distinct input of an attention's three
    projections, computed once (k and v usually share a tensor)."""
    pq = quantize_rows(query)
    pk = pq if key is query else quantize_rows(key)
    pv = pk if value is key else (pq if value is query
                                  else quantize_rows(value))
    return pq, pk, pv


class CrossAttention(nn.Module):
    """``nn.MultiheadAttention(batch_first=True)`` equivalent with separate
    q/k/v projections (bias) and an output projection (bias); with
    ``quant`` the projections are W8A8, each distinct input quantized
    once."""

    def __init__(self, dim: int, num_heads: int, quant: bool = False):
        super().__init__()
        self.num_heads, self.quant = num_heads, quant
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value):
        h = self.num_heads
        inputs = (query, key, value)
        pre = shared_prequant(*inputs) if self.quant else (None,) * 3
        q, k, v = (project(layer, x, self.quant, p) for layer, x, p in zip(
            (self.q_proj, self.k_proj, self.v_proj), inputs, pre))
        out = merge_heads(scaled_dot_attention(
            split_heads(q, h), split_heads(k, h), split_heads(v, h)))
        return project(self.out_proj, out, self.quant)


class Mlp(nn.Module):
    """timm Mlp: fc1 -> GELU(tanh) -> fc2; with ``quant`` both W8A8."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int,
                 quant: bool = False):
        super().__init__()
        self.quant = quant
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x):
        y = F.gelu(project(self.fc1, x, self.quant), approximate="tanh")
        return project(self.fc2, y, self.quant)


class PatchEmbed(nn.Module):
    """Conv patchify: NCHW image -> (N, T, D) tokens, row-major patches."""

    def __init__(self, in_ch: int, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """GLIDE sinusoidal embedding, cat([cos, sin]) order, in ``dtype``
    (f32, or f64 for a float64 model)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=dtype, device=t.device) / half)
    args = t.to(dtype)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, freq_embed_size: int = 256):
        super().__init__()
        self.freq_embed_size = freq_embed_size
        self.mlp_0 = nn.Linear(freq_embed_size, hidden_size)
        self.mlp_2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, t):
        dtype = self.mlp_0.weight.dtype
        x = timestep_embedding(t, self.freq_embed_size,
                               dtype=torch.promote_types(dtype, torch.float32))
        x = x.to(dtype)
        return self.mlp_2(F.silu(self.mlp_0(x)))


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """MAE-style fixed 2D sin-cos table (grid_size^2, embed_dim): sin/cos per
    axis, h-embedding first (reference ``cross_model.py:677-722``)."""

    def one_d(dim: int, pos: np.ndarray) -> np.ndarray:
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000.0 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g), axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = one_d(embed_dim // 2, grid[0])
    emb_w = one_d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def fold_conv_bn(conv: nn.Conv2d, bn: Optional[BatchNorm],
                 dtype: torch.dtype):
    """(weight in ``dtype``, scale f32, bias f32, K-major weights) for K2:
    the conv bias and the frozen BN folded as ``planar_aux._fused_affine``
    does, and the kernel's weight operand: ``k_major_weights`` in bf16,
    its three-way split ``k_major_weights_split`` in f32, else None.

    Cached on the conv, keyed by the dtype, the weights' storage and their
    version counters, so it is recomputed only after the weights are
    replaced, moved or loaded (``load_state_dict`` copies in place and
    bumps the counters)."""
    tensors = [conv.weight, conv.bias] + (
        [bn.scale, bn.bias, bn.mean, bn.var] if bn else [])
    key = (dtype,) + tuple((t.data_ptr(), t._version) for t in tensors)
    cached = conv.__dict__.get("_k2_fold")
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        w = conv.weight.detach().to(dtype).contiguous()
        b = conv.bias.detach().float()
        if bn is None:
            scale = torch.ones_like(b)
        else:
            scale, shift = bn.affine()
            b = b * scale + shift
        wk = (k_major_weights(w) if dtype == torch.bfloat16 else
              k_major_weights_split(w) if dtype == torch.float32 else None)
    folded = (w, scale.contiguous(), b.contiguous(), wk)
    conv.__dict__["_k2_fold"] = (key, folded)
    return folded


def conv3x3_folded(conv: nn.Conv2d, bn: Optional[BatchNorm], x: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    """A 3x3 conv (+ a frozen BN, folded) through K2.  A conv without BN
    takes its live weights through the autograd Function when a gradient
    is needed (the DiT's trainable pyramid); a BN'd conv belongs to a
    frozen aux net and always takes the folded, detached cache."""
    if bn is None and torch.is_grad_enabled() and (
            conv.weight.requires_grad or x.requires_grad):
        return conv3x3_trainable(x, conv.weight, conv.bias, conv.dilation[0],
                                 relu)
    w, scale, bias, wk = fold_conv_bn(conv, bn, x.dtype)
    return conv3x3(x, w, scale, bias, conv.dilation[0], relu, wk)


def conv1x1_f32(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv + bias in f32, result in x's dtype (``conv1x1_planar``): an
    f32 matmul over the channels, as the reference's f32 einsum.  A cuDNN
    f32 convolution would round to TF32 under torch's default
    ``cudnn.allow_tf32=True``; a matmul stays f32 (``cuda.matmul.allow_tf32``
    is False by default)."""
    b, c, h, w = x.shape
    y = torch.matmul(conv.weight.float().reshape(-1, c),
                     x.float().reshape(b, c, h * w))
    return (y + conv.bias.float()[:, None]).reshape(b, -1, h, w).to(x.dtype)


def conv_matmul(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A convolution K2 does not take (GeoTr's 7x7 stem, its stride-2
    3x3s) as an im2col matmul in x's dtype, with the conv's stride and
    padding: an f32 one stays f32 on the card whatever
    ``cudnn.allow_tf32`` says (``cuda.matmul.allow_tf32`` is False by
    default), as ``conv1x1_f32``."""
    b, _, h, w = x.shape
    kh, kw = conv.kernel_size
    (sh, sw), (ph, pw) = conv.stride, conv.padding
    cols = F.unfold(x, (kh, kw), padding=(ph, pw), stride=(sh, sw))
    y = torch.matmul(conv.weight.to(x.dtype).reshape(conv.out_channels, -1),
                     cols) + conv.bias.to(x.dtype)[:, None]
    return y.reshape(b, -1, (h + 2 * ph - kh) // sh + 1,
                     (w + 2 * pw - kw) // sw + 1)


# layers that training initialises to zero (the DiT's adaLN-zero gates and
# final projection; the UNet denoiser's ResBlock ``conv_out``,
# AttentionBlock ``proj_out`` and ``out_conv``): random weights give them
# N(0, std^2), as the parity tests fill the zero leaves of ``dvd_tpu``'s
# init
ZERO_INIT_LAYERS = ("adaLN_modulation_1.", "final_layer2.linear.",
                    "final_layer.linear.", "conv_out.", "proj_out.",
                    "out_conv.")


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02, zero_init: bool = False) -> nn.Module:
    """Random weights from an explicit generator, with no zero leaf (so the
    DiT's zero-initialised layers carry signal): matrices and conv kernels
    N(0, 1/fan_in), except the ``ZERO_INIT_LAYERS``, N(0, std^2); norm
    scales 1 + N(0, std^2); BN variances in [0.5, 1.5]; every other leaf
    N(0, std^2).  Draws on the CPU, in ``state_dict`` order.

    ``zero_init`` starts the ``ZERO_INIT_LAYERS`` at zero instead, as
    training from scratch does (the reference's adaLN-zero init: the DiT
    then predicts ``init_flow`` exactly); every other leaf keeps the value
    it has without it."""
    for name, t in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf == "weight" and t.dim() >= 2 and not any(
                z in name for z in ZERO_INIT_LAYERS):
            fan_in = t[0].numel()
            val = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
        elif leaf == "scale":
            val = 1 + std * torch.randn(shape, generator=generator)
        elif leaf == "var":
            val = 0.5 + torch.rand(shape, generator=generator)
        else:
            val = std * torch.randn(shape, generator=generator)
        if zero_init and any(z in name for z in ZERO_INIT_LAYERS):
            val = torch.zeros_like(val)
        t.copy_(val)
    return module


class LayerNorm(nn.Module):
    """LayerNorm with affine, flax leaf names (``scale``, ``bias``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``'s parameters (``scale``, ``bias``) over NCHW
    x: ``F.group_norm``, two-pass statistics in x's dtype."""

    def __init__(self, num_groups: int, features: int, eps: float):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.scale.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class GroupNorm32(nn.Module):
    """GroupNorm over min(32, C) groups, eps 1e-5, computed in f32 (at
    least), the result in x's dtype (``dvd_tpu`` ``GroupNorm32``;
    reference ``nn.py:13-20,103``).  flax computes the variance as
    E[x^2] - E[x]^2; this is two-pass, which at f32 differs by about 1e-6
    of the normalised signal and keeps its precision where the mean is
    large."""

    def __init__(self, features: int, num_groups: int = 32):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(num_groups, features), features,
                                     1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(at_least_f32(x)).to(x.dtype)


def compute_dtype(weight: torch.Tensor) -> torch.dtype:
    """The dtype a module with ``weight`` computes in: autocast's when it
    is on for the weight's device (f32 training parameters), else the
    weight's own (serving stores the model in the compute dtype)."""
    if torch.is_autocast_enabled(weight.device.type):
        return torch.get_autocast_dtype(weight.device.type)
    return weight.dtype


def conv3x3_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A stride-1 3x3 'SAME' conv + bias through K2 (the trainable
    Function when a gradient is needed), x cast to the conv's compute
    dtype."""
    return conv3x3_folded(conv, None,
                          x.to(compute_dtype(conv.weight)).contiguous(), False)


class BatchNorm(nn.Module):
    """BatchNorm with flax's leaf names (``scale``, ``bias`` parameters;
    ``mean``, ``var`` running statistics as buffers).

    Eval (the serving path and the frozen aux nets, which fold it into
    K2) uses the stored statistics.  Train mode (the SATRN decoder of the
    trained DiT) is flax's ``nn.BatchNorm(use_running_average=False)``:
    normalise with the batch's f32 mean and biased variance
    ``max(0, E[x^2] - E[x]^2)``.  It does not touch the running statistics
    itself: it keeps the batch's statistics in ``batch_stats`` and
    :func:`commit_batch_stats` folds the last call's into them, as the JAX
    train step keeps one update per step from its last model call.

    Under data parallelism (``group``, the data group, set by
    ``parallel.mesh.shard_params``) E[x] and E[x^2] are averaged over the
    group's equal local batches, with their gradient: the global batch's
    moments, as ``dvd_tpu``'s step over a sharded batch takes them."""

    group = None

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.batch_stats = None

    def affine(self):
        """(inv, shift) in f32 with ``bn(x) = x * inv + shift``; callers
        fold it into the neighbouring conv or apply it channel-last."""
        inv = torch.rsqrt(at_least_f32(self.var) + self.eps) \
            * at_least_f32(self.scale)
        return inv, at_least_f32(self.bias) - at_least_f32(self.mean) * inv

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Channel-last x (..., C) -> x's dtype."""
        if not train:
            inv, shift = self.affine()
            return x * inv.to(x.dtype) + shift.to(x.dtype)
        dims = tuple(range(x.dim() - 1))
        x32 = at_least_f32(x)
        mean, msq = x32.mean(dims), (x32 * x32).mean(dims)
        if self.group is not None:
            moments = comm.all_reduce_sum(torch.stack([mean, msq]),
                                          self.group)
            mean, msq = moments / comm.group_size(self.group)
        var = torch.clamp(msq - mean * mean, min=0.0)
        self.batch_stats = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * at_least_f32(self.scale)
        return ((x32 - mean) * mul + at_least_f32(self.bias)).to(x.dtype)


@torch.no_grad()
def commit_batch_stats(module: nn.Module) -> None:
    """Fold each train-mode BatchNorm's last batch statistics into its
    running ones, flax-style: ``ra = momentum * ra + (1 - momentum) *
    batch`` (biased variance); then forget them."""
    for m in module.modules():
        if isinstance(m, BatchNorm) and m.batch_stats is not None:
            mean, var = m.batch_stats
            m.mean.copy_(m.momentum * m.mean + (1 - m.momentum) * mean)
            m.var.copy_(m.momentum * m.var + (1 - m.momentum) * var)
            m.batch_stats = None


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep with probability 1 - rate
    (a uniform draw from ``generator`` on x's device, for the global
    batch's rows under ``comm.batch_rows``), scale by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    keep = comm.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
