"""Pure-transformer alternative denoiser, ``train_mode =
'stage_1_transformer'`` (port of ``dvd_tpu/models/transformer_denoiser.py``;
reference ``improved_diffusion/transformer.py``, ``DDIMWithTransformer``).

A 3x3 conv projects cat[src_feat (64), x (2), init_flow (2)] to
``model_channels``; then ``num_layers`` input blocks, a middle block and
``num_layers`` output blocks of post-norm self-attention over the H*W
tokens, the timestep embedding added to the tokens before every block;
a SiLU + 3x3 conv head and the residual ``+ init_flow``.

Kernels: ``x_projection`` and ``out_1`` through K2; each block's attention
(``CrossAttention``, Dh = model_channels / num_heads: 32 at the registry's
width, over 64^2 = 4096 tokens) through K1.  Flows channel-last,
conditioning NCHW, tokens (N, T, D); the output f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.models.layers import (CrossAttention, LayerNorm,
                                         compute_dtype, conv3x3_same,
                                         timestep_embedding)
from dvd_tpu_torch.utils.dtypes import at_least_f32


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.attn = CrossAttention(dim, num_heads)
        self.norm1 = LayerNorm(dim)
        self.ffn_0 = nn.Linear(dim, ff_dim)
        self.ffn_2 = nn.Linear(ff_dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.attn(x, x, x))
        return self.norm2(x + self.ffn_2(F.relu(self.ffn_0(x))))


class TransformerDenoiser(nn.Module):
    def __init__(self, in_channels: int = 68, model_channels: int = 128,
                 out_channels: int = 2, num_heads: int = 4,
                 num_layers: int = 6, ff_dim: int = 256):
        super().__init__()
        mc = self.model_channels = model_channels
        self.num_layers = num_layers
        self.time_embed_0 = nn.Linear(mc, 4 * mc)
        self.time_embed_2 = nn.Linear(4 * mc, mc)
        self.x_projection = nn.Conv2d(in_channels, mc, 3, padding=1)
        names = [f"input_blocks_{i}" for i in range(num_layers)] \
            + ["middle_block"] \
            + [f"output_blocks_{i}" for i in range(num_layers)]
        for name in names:
            setattr(self, name, TransformerBlock(mc, num_heads, ff_dim))
        self.block_names = tuple(names)
        self.out_1 = nn.Conv2d(mc, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                src_feat: Optional[torch.Tensor] = None,
                init_flow: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, S, S, 2), t (N,), src_feat (N, 64, S, S), init_flow
        (N, S, S, 2) -> the (N, S, S, 2) f32 flow.  Without init_flow
        the 2-channel x itself is tokenised, as upstream."""
        dt = compute_dtype(self.out_1.weight)
        emb = self.time_embed_0(
            timestep_embedding(t, self.model_channels).to(dt))
        emb = self.time_embed_2(F.silu(emb))[:, None]
        h = x.permute(0, 3, 1, 2)
        if init_flow is not None:
            h = conv3x3_same(self.x_projection, torch.cat(
                [src_feat, h, init_flow.permute(0, 3, 1, 2)], dim=1))
        n, c, hh, ww = h.shape
        tok = h.to(dt).flatten(2).transpose(1, 2)
        for name in self.block_names:
            tok = getattr(self, name)(tok + emb)
        y = tok.transpose(1, 2).reshape(n, c, hh, ww)
        y = at_least_f32(conv3x3_same(self.out_1, F.silu(y))
                         .permute(0, 2, 3, 1))
        return y + init_flow if init_flow is not None else y
