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
from dvd_tpu_torch.ops.kernels.conv3x3 import conv3x3


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation ``x * (1 + scale) + shift`` with (N, D) conditioners."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, statistics in f32, result in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


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
    """timm-style fused-QKV self attention (qkv_bias=True)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        h = self.num_heads
        out = scaled_dot_attention(split_heads(q, h), split_heads(k, h),
                                   split_heads(v, h))
        return self.proj(merge_heads(out))


class CrossAttention(nn.Module):
    """``nn.MultiheadAttention(batch_first=True)`` equivalent with separate
    q/k/v projections (bias) and an output projection (bias)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value):
        h = self.num_heads
        out = scaled_dot_attention(split_heads(self.q_proj(query), h),
                                   split_heads(self.k_proj(key), h),
                                   split_heads(self.v_proj(value), h))
        return self.out_proj(merge_heads(out))


class Mlp(nn.Module):
    """timm Mlp: fc1 -> GELU(tanh) -> fc2."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class PatchEmbed(nn.Module):
    """Conv patchify: NCHW image -> (N, T, D) tokens, row-major patches."""

    def __init__(self, in_ch: int, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """GLIDE sinusoidal embedding, cat([cos, sin]) order, in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
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
        x = timestep_embedding(t, self.freq_embed_size).to(self.mlp_0.weight.dtype)
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
    """(weight in ``dtype``, scale f32, bias f32) for K2: the conv bias and
    the frozen BN folded as ``planar_aux._fused_affine`` does.

    Cached on the conv, keyed by the dtype, the weights' storage and their
    version counters, so it is recomputed only after the weights are
    replaced, moved or loaded (``load_state_dict`` copies in place and
    bumps the counters)."""
    tensors = [conv.weight, conv.bias] + (list(bn.buffers()) if bn else [])
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
    conv.__dict__["_k2_fold"] = (key, (w, scale.contiguous(), b.contiguous()))
    return w, scale, b


def conv3x3_folded(conv: nn.Conv2d, bn: Optional[BatchNorm], x: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    w, scale, bias = fold_conv_bn(conv, bn, x.dtype)
    return conv3x3(x, w, scale, bias, conv.dilation[0], relu)


def conv1x1_f32(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv + bias in f32, result in x's dtype (``conv1x1_planar``)."""
    return F.conv2d(x.float(), conv.weight.float(), conv.bias.float()).to(x.dtype)


# layers that training initialises to zero (the DiT's adaLN-zero gates and
# final projection): random weights give them N(0, std^2), as the parity
# tests fill the zero leaves of ``dvd_tpu``'s init
ZERO_INIT_LAYERS = ("adaLN_modulation_1.", "final_layer2.linear.")


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Random weights from an explicit generator, with no zero leaf (so the
    DiT's zero-initialised layers carry signal): matrices and conv kernels
    N(0, 1/fan_in), except the ``ZERO_INIT_LAYERS``, N(0, std^2); norm
    scales 1 + N(0, std^2); BN variances in [0.5, 1.5]; every other leaf
    N(0, std^2).  Draws on the CPU, in ``state_dict`` order."""
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


class BatchNorm(nn.Module):
    """BatchNorm evaluated with stored statistics (every use in the serving
    path is eval/frozen).  Buffers ``scale``, ``bias``, ``mean``, ``var``
    keep the flax names; nothing is folded here."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self):
        """(inv, shift) in f32 with ``bn(x) = x * inv + shift``; callers
        fold it into the neighbouring conv or apply it channel-last."""
        inv = torch.rsqrt(self.var.float() + self.eps) * self.scale.float()
        return inv, self.bias.float() - self.mean.float() * inv
