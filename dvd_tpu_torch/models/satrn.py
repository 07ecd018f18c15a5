"""SATRN-style fusion decoder, the DiT's multi-stream fusion head (port of
``dvd_tpu/models/satrn.py``; reference ``cross_attn.py``).

Locality-aware feed-forward (1x1 -> depthwise 3x3 -> 1x1, each
Conv-BN-ReLU without conv bias), adaptive 2D positional encoding with
learned per-sample H/W scales, and pre-norm self-attention layers.  The
decoder works channel-last ((N, h, w, C) images, (N, T, C) tokens): the
1x1 convs are then plain linear maps, and only the depthwise 3x3 runs as
an NCHW ``F.conv2d``.

``train=True`` is flax's ``deterministic=False, use_running_average=False``:
the BNs normalise with batch statistics (``layers.BatchNorm``) and dropout
(``dropout`` rate, a constructor argument as in flax) draws its masks from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.models.layers import (BatchNorm, LayerNorm, dropout,
                                         merge_heads, scaled_dot_attention,
                                         split_heads)


def satrn_sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """(n_position, d_hid): pos / 10000^(2*(j//2)/d); even cols sin, odd cos
    (reference ``cross_attn.py:122-134``)."""
    j = np.arange(d_hid)
    denom = 1.0 / np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.arange(n_position)[:, None].astype(np.float64) * denom[None, :]
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)


class ConvBNReLU(nn.Module):
    """Conv (no bias) -> BN -> ReLU on channel-last input.  ``kernel`` 1 is
    a linear map over channels; 3 is a depthwise 3x3 (groups=C)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 groups: int = 1):
        super().__init__()
        self.kernel = kernel
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor,
                train: bool = False) -> torch.Tensor:   # (N, h, w, C)
        if self.kernel == 1:
            y = F.linear(x, self.conv.weight.flatten(1))
        else:
            y = self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.relu(self.bn(y, train))


class LocalityAwareFeedforward(nn.Module):
    def __init__(self, d_in: int, d_hid: int):
        super().__init__()
        self.conv1 = ConvBNReLU(d_in, d_hid, 1)
        self.depthwise_conv = ConvBNReLU(d_hid, d_hid, 3, groups=d_hid)
        self.conv2 = ConvBNReLU(d_hid, d_in, 1)

    def forward(self, x, train: bool = False):
        x = self.depthwise_conv(self.conv1(x, train), train)
        return self.conv2(x, train)


class Adaptive2DPositionalEncoding(nn.Module):
    """x + h_scale(pool(x)) * h_sinusoid + w_scale(pool(x)) * w_sinusoid."""

    def __init__(self, d_hid: int, n_height: int, n_width: int,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.register_buffer("h_table", torch.from_numpy(
            satrn_sinusoid_table(n_height, d_hid)), persistent=False)
        self.register_buffer("w_table", torch.from_numpy(
            satrn_sinusoid_table(n_width, d_hid)), persistent=False)
        for name in ("h_scale", "w_scale"):
            setattr(self, f"{name}_0", nn.Conv2d(d_hid, d_hid, 1))
            setattr(self, f"{name}_2", nn.Conv2d(d_hid, d_hid, 1))

    def _scale(self, name: str, pooled: torch.Tensor) -> torch.Tensor:
        c0, c2 = getattr(self, f"{name}_0"), getattr(self, f"{name}_2")
        y = torch.relu(F.linear(pooled, c0.weight.flatten(1), c0.bias))
        return torch.sigmoid(F.linear(y, c2.weight.flatten(1), c2.bias))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:   # (N, h, w, C)
        _, h, w, _ = x.shape
        pooled = x.mean(dim=(1, 2))
        hs = self._scale("h_scale", pooled)[:, None, None, :]
        ws = self._scale("w_scale", pooled)[:, None, None, :]
        h_pos = self.h_table[:h].to(x.dtype)[None, :, None, :]
        w_pos = self.w_table[:w].to(x.dtype)[None, None, :, :]
        out = x + hs * h_pos + ws * w_pos
        return dropout(out, self.dropout, generator) if train else out


class SATRNAttention(nn.Module):
    """Separate q/k/v projections without bias, scale 1/sqrt(d_k)."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_k, self.dropout = n_head, d_k, dropout
        self.linear_q = nn.Linear(d_model, n_head * d_k, bias=False)
        self.linear_k = nn.Linear(d_model, n_head * d_k, bias=False)
        self.linear_v = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        h = self.n_head
        out = scaled_dot_attention(split_heads(self.linear_q(x), h),
                                   split_heads(self.linear_k(x), h),
                                   split_heads(self.linear_v(x), h),
                                   scale=1.0 / self.d_k ** 0.5)
        out = self.fc(merge_heads(out))
        return dropout(out, self.dropout, generator) if train else out


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int,
                 d_v: int, dropout: float = 0.1):
        super().__init__()
        self.norm1 = LayerNorm(d_model)
        self.attn = SATRNAttention(n_head, d_model, d_k, d_v, dropout)
        self.norm2 = LayerNorm(d_model)
        self.feed_forward = LocalityAwareFeedforward(d_model, d_inner)

    def forward(self, x: torch.Tensor, h: int, w: int, train: bool = False,
                generator=None) -> torch.Tensor:
        n, t, c = x.shape
        x = x + self.attn(self.norm1(x), train, generator)
        y = self.feed_forward(self.norm2(x).reshape(n, h, w, c), train)
        return x + y.reshape(n, t, c)


class Decoder(nn.Module):
    """Decoder layers over the concatenated DiT streams: (N, h, w, D_model)
    -> tokens (N, h*w, D_model) (reference ``cross_attn.py:399-458``)."""

    def __init__(self, n_layers: int = 6, n_head: int = 6, d_k: int = 256,
                 d_v: int = 256, d_model: int = 1536, n_position: int = 32,
                 d_inner: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.n_layers = n_layers
        self.position_dec = Adaptive2DPositionalEncoding(
            d_model, n_position, n_position, dropout)
        for i in range(n_layers):
            setattr(self, f"layer_stack_{i}",
                    DecoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout))
        self.layer_norm = LayerNorm(d_model)

    def forward(self, feat: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        n, h, w, c = feat.shape
        x = self.position_dec(feat, train, generator).reshape(n, h * w, c)
        for i in range(self.n_layers):
            x = getattr(self, f"layer_stack_{i}")(x, h, w, train, generator)
        return self.layer_norm(x)
