"""Improved-diffusion-style UNet denoiser, the alternative ``train_mode``
values ``stage_1`` / ``sr`` / ``trg_feat`` (port of
``dvd_tpu/models/unet_denoiser.py``; reference
``improved_diffusion/unet.py``).

ResBlocks with optional scale-shift GroupNorm conditioning, QKV attention
blocks at the configured downsampling ratios, stride-2 conv downsampling,
nearest x2 upsampling + conv, a skip-concat decoder, a zero-initialised
output conv and the residual ``+ init_flow``.

Input assembly per mode (``unet.py:750-762``):
- ``stage_1``: cat[src_feat (64), x (2), init_flow (2)] -> 68 ch (without
  init_flow, 66);
- ``trg_feat``: cat[x, init_flow, local_corr (81), l2norm(trg_feat)] -> 149;
- ``sr``: cat[x, init_flow, local_corr] -> 85 (``unet.py:441-461``).

Kernels: every stride-1 3x3 conv (``in_conv``, the ResBlocks', the
``upsample_*`` and ``out_conv``) through K2; the stride-2 downsamples as
im2col matmuls (``layers.conv_matmul``) and the 1x1 ``skip_connection``s
as ``conv1x1_f32``, so TF32 reaches none of them; the attention through
K1, with 1/sqrt(Dh) passed once where ``dvd_tpu`` splits it as Dh^-1/4 on
q and on k (Dh 96, the 384-channel level's, runs zero-padded to 128).

Layout: flows channel-last (N, S, S, 2) in and out, as the sampler's;
conditioning and feature maps NCHW.  The model computes in its weights'
dtype, or autocast's (``layers.compute_dtype``); the output is f32.
Module names follow the flax parameter paths.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.models.layers import (GroupNorm32, compute_dtype,
                                         conv1x1_f32, conv3x3_same,
                                         conv_matmul, merge_heads,
                                         scaled_dot_attention, split_heads,
                                         timestep_embedding)
from dvd_tpu_torch.utils.dtypes import at_least_f32


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 use_scale_shift_norm: bool = True):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norm_in = GroupNorm32(in_ch)
        self.conv_in = _conv3x3(in_ch, out_ch)
        self.emb_proj = nn.Linear(
            emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch)
        self.norm_out = GroupNorm32(out_ch)
        self.conv_out = _conv3x3(out_ch, out_ch)
        self.skip_connection = nn.Conv2d(in_ch, out_ch, 1) \
            if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = conv3x3_same(self.conv_in, F.silu(self.norm_in(x)))
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.norm_out(h) * (1 + scale) + shift)
        else:
            h = F.silu(self.norm_out(h + emb_out))
        h = conv3x3_same(self.conv_out, h)
        if self.skip_connection is not None:
            x = conv1x1_f32(self.skip_connection, x)
        return x + h


class AttentionBlock(nn.Module):
    """GroupNorm -> fused qkv -> softmax attention over the plane's tokens
    (K1) -> zero-initialised ``proj_out``, residual."""

    def __init__(self, channels: int, num_heads: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        nh = self.num_heads
        y = self.norm(x).flatten(2).transpose(1, 2)          # (N, HW, C)
        q, k, v = (split_heads(z, nh) for z in self.qkv(y).chunk(3, dim=-1))
        out = scaled_dot_attention(q, k, v, 1.0 / math.sqrt(c // nh))
        out = self.proj_out(merge_heads(out))
        return x + out.transpose(1, 2).reshape(n, c, h, w)


class UNetDenoiser(nn.Module):
    def __init__(self, in_channels: int = 68, model_channels: int = 128,
                 out_channels: int = 2, num_res_blocks: int = 3,
                 attention_ds: Sequence[int] = (4, 8),
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 num_heads: int = 4, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = True,
                 train_mode: str = "stage_1"):
        super().__init__()
        mc = model_channels
        self.in_channels, self.model_channels = in_channels, mc
        self.num_res_blocks = num_res_blocks
        self.attention_ds = tuple(attention_ds)
        self.channel_mult = tuple(channel_mult)
        self.train_mode = train_mode
        nhu = num_heads if num_heads_upsample == -1 else num_heads_upsample
        emb_dim = 4 * mc
        self.time_embed_0 = nn.Linear(mc, emb_dim)
        self.time_embed_2 = nn.Linear(emb_dim, emb_dim)

        def res(name, cin, cout):
            setattr(self, name, ResBlock(cin, cout, emb_dim,
                                         use_scale_shift_norm))

        self.in_conv = _conv3x3(in_channels, mc)
        chans, ch, ds, bi = [mc], mc, 1, 0
        for level, mult in enumerate(self.channel_mult):
            for _ in range(num_res_blocks):
                res(f"down_{bi}", ch, mult * mc)
                ch = mult * mc
                if ds in self.attention_ds:
                    setattr(self, f"down_attn_{bi}",
                            AttentionBlock(ch, num_heads))
                chans.append(ch)
                bi += 1
            if level != len(self.channel_mult) - 1:
                setattr(self, f"downsample_{level}", _conv3x3(ch, ch, 2))
                chans.append(ch)
                ds *= 2
        res("middle_res1", ch, ch)
        self.middle_attn = AttentionBlock(ch, num_heads)
        res("middle_res2", ch, ch)
        bi = 0
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                res(f"up_{bi}", ch + chans.pop(), mult * mc)
                ch = mult * mc
                if ds in self.attention_ds:
                    setattr(self, f"up_attn_{bi}", AttentionBlock(ch, nhu))
                bi += 1
                if level and i == num_res_blocks:
                    setattr(self, f"upsample_{level}", _conv3x3(ch, ch))
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = _conv3x3(ch, out_channels)

    def _input(self, x, src_feat, init_flow, local_corr, trg_feat):
        """The conditioning concat of the mode (NCHW), its width checked
        against ``in_channels`` so that a wrong conditioning set fails
        loudly instead of feeding a different model."""
        flow = init_flow.permute(0, 3, 1, 2) if init_flow is not None \
            else None
        if self.train_mode == "trg_feat":
            tf = trg_feat / (trg_feat.pow(2).sum(1, keepdim=True).sqrt()
                             + 1e-6)
            parts = [x, flow, local_corr, tf]
        elif self.train_mode == "sr":
            parts = [x, flow, local_corr]
        else:
            parts = [src_feat, x] + ([flow] if flow is not None else [])
        h = torch.cat(parts, dim=1)
        if h.shape[1] != self.in_channels:
            raise ValueError(
                f"train_mode={self.train_mode!r} conditioning concat has "
                f"{h.shape[1]} channels, expected in_channels="
                f"{self.in_channels}")
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                src_feat: Optional[torch.Tensor] = None,
                init_flow: Optional[torch.Tensor] = None,
                local_corr: Optional[torch.Tensor] = None,
                trg_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, S, S, 2), t (N,), src_feat (N, 64, S, S), init_flow
        (N, S, S, 2); ``sr``/``trg_feat``: local_corr (N, 81, S, S) and
        trg_feat (N, 64, S, S) -> the (N, S, S, 2) f32 flow."""
        dt = compute_dtype(self.in_conv.weight)
        emb = self.time_embed_0(
            timestep_embedding(t, self.model_channels).to(dt))
        emb = self.time_embed_2(F.silu(emb))
        h = conv3x3_same(self.in_conv, self._input(
            x.permute(0, 3, 1, 2), src_feat, init_flow, local_corr,
            trg_feat))
        hs = [h]
        ds, bi = 1, 0
        for level, _ in enumerate(self.channel_mult):
            for _ in range(self.num_res_blocks):
                h = getattr(self, f"down_{bi}")(h, emb)
                if ds in self.attention_ds:
                    h = getattr(self, f"down_attn_{bi}")(h)
                hs.append(h)
                bi += 1
            if level != len(self.channel_mult) - 1:
                h = conv_matmul(getattr(self, f"downsample_{level}"), h)
                hs.append(h)
                ds *= 2
        h = self.middle_res2(self.middle_attn(self.middle_res1(h, emb)), emb)
        bi = 0
        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{bi}")(torch.cat([h, hs.pop()], 1),
                                              emb)
                if ds in self.attention_ds:
                    h = getattr(self, f"up_attn_{bi}")(h)
                bi += 1
                if level and i == self.num_res_blocks:
                    # jax.image.resize 'nearest' at a factor of 2
                    h = F.interpolate(h, scale_factor=2, mode="nearest")
                    h = conv3x3_same(getattr(self, f"upsample_{level}"), h)
                    ds //= 2
        out = conv3x3_same(self.out_conv, F.silu(self.out_norm(h)))
        out = at_least_f32(out.permute(0, 2, 3, 1))
        return out + init_flow if init_flow is not None else out
