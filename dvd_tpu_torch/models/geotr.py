"""GeoTr coarse dewarper and its document-mask wrappers (frozen aux nets;
port of ``dvd_tpu/models/geotr.py``, reference ``geotr_core.py:337-740,
962-1040`` and ``geotr/extractor.py``).

- RAFT ``BasicEncoder``: 7x7/2 conv + instance norm, residual layers to
  /8, a 1x1 head to 256 ch; instance norm without affine parameters;
- ``AttnLayer``: post-norm self-attention, one cross-attention over the
  memory and an FFN, with DETR sine position embeddings added to the
  queries and keys;
- ``TransEncoder`` and ``TransDecoder`` (a learned (tokens x 256) query
  bank), six layers each;
- RAFT ``UpdateBlock`` and the convex 8x upsampling of the coarse flow;
- ``GeoTr``: a P^2 image -> the backward map's offsets (pixels) at P^2;
- ``GeoTrSegInf``: the soft U2NetP mask times the image -> GeoTr, and the
  mask upsampled to ``mask_size``; ``GeoTrSeg`` with the hard 0.5 mask;
  ``GeoTrSegWoMask`` without one;
- ``GeoTr2``, the alternative denoiser ``stage_1_doctr``, on
  ``BasicEncoder2``.

Serving builds ``GeoTrSegInf`` with its GeoTr only under
``use_init_flow=True``: otherwise only the mask reaches the DiT (the
``mask_cat`` channel), its forward returns ``(None, mask)`` and the
weight bridge skips a file's ``GeoTr`` subtree (``absent_subtrees``).

Kernels: the stride-1 3x3 convs (each ResidualBlock's ``conv2`` and
stride-1 ``conv1``, ``mask_0``, ``flow_head_conv1/2``) run through K2
(scale 1, bias = the conv bias, ReLU in the epilogue where it follows
directly); the 7x7 stem and the stride-2 3x3s as im2col matmuls
(``layers.conv_matmul``), the 1x1s as ``conv1x1_f32``; the twelve
layers' attention (8 heads of 32 over the (P/8)^2 tokens) through K1.
Everything runs in the input's dtype (the compute dtype), the flow
offsets in f32 as ``dvd_tpu`` promotes them.  Images NCHW, tokens (N, T,
D), flows and maps channel-last (N, H, W, 2).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.models.layers import (CrossAttention, LayerNorm,
                                         compute_dtype, conv1x1_f32,
                                         conv3x3_folded, conv_matmul)
from dvd_tpu_torch.models.u2net import U2NetP
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.utils import graphs
from dvd_tpu_torch.utils.dtypes import at_least_f32


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch ``nn.InstanceNorm2d``'s default: no affine, each sample's and
    channel's plane normalised with its biased variance, in f32; the
    result in x's dtype."""
    x32 = at_least_f32(x)
    mean = x32.mean((2, 3), keepdim=True)
    var = ((x32 - mean) ** 2).mean((2, 3), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor, relu: bool = False
          ) -> torch.Tensor:
    """A 3x3 'SAME' conv: K2 at stride 1, an im2col matmul at stride 2."""
    if conv.stride == (1, 1):
        return conv3x3_folded(conv, None, x, relu)
    y = conv_matmul(conv, x)
    return F.relu(y) if relu else y


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    s = conv.stride[0]
    return conv1x1_f32(conv, x[:, :, ::s, ::s] if s > 1 else x)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        # the standard 1x1 projection wherever the shapes change (see
        # dvd_tpu's ResidualBlock)
        self.downsample_0 = nn.Conv2d(in_planes, planes, 1, stride) \
            if stride != 1 or in_planes != planes else None

    def forward(self, x):
        y = F.relu(instance_norm(_conv(self.conv1, x)))
        y = F.relu(instance_norm(_conv(self.conv2, y)))
        if self.downsample_0 is not None:
            x = instance_norm(_conv1x1(self.downsample_0, x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT encoder: 3 ch -> ``output_dim`` at /8 (reference
    extractor.py:59-115)."""

    def __init__(self, output_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        for name, cin, cout, stride in (
                ("layer1_0", 64, 64, 1), ("layer1_1", 64, 64, 1),
                ("layer2_0", 64, 128, 2), ("layer2_1", 128, 128, 1),
                ("layer3_0", 128, 192, 2), ("layer3_1", 192, 192, 1)):
            setattr(self, name, ResidualBlock(cin, cout, stride))
        self.conv2 = nn.Conv2d(192, output_dim, 1)

    def forward(self, x):
        x = F.relu(instance_norm(conv_matmul(self.conv1, x)))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1",
                     "layer3_0", "layer3_1"):
            x = getattr(self, name)(x)
        return conv1x1_f32(self.conv2, x)


class BasicEncoder2(nn.Module):
    """GeoTr2's encoder: no stem conv and no layer3; an ``in_planes``-ch
    input at full resolution -> ``output_dim`` at /2 (reference
    extractor.py:119-174).  ``layer1_0`` takes its 68 channels through the
    1x1 projection that ``dvd_tpu`` adds where the shapes change (upstream
    has none there, see ``GeoTr2``)."""

    def __init__(self, in_planes: int = 68, output_dim: int = 256):
        super().__init__()
        for name, cin, cout, stride in (
                ("layer1_0", in_planes, 64, 1), ("layer1_1", 64, 64, 1),
                ("layer2_0", 64, 128, 2), ("layer2_1", 128, 128, 1)):
            setattr(self, name, ResidualBlock(cin, cout, stride))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(instance_norm(x))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1"):
            x = getattr(self, name)(x)
        return conv1x1_f32(self.conv2, x)


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0) -> np.ndarray:
    """DETR PositionEmbeddingSine with normalize=True over an all-ones mask
    (reference position_encoding.py:36-77) -> (h, w, 2 * num_pos_feats),
    channel order [y-embed, x-embed]; float64 numpy, then f32."""
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x = np.ones((h, 1)) * np.arange(1, w + 1, dtype=np.float64)[None, :]
    y = y / (h + 1e-6) * (2 * math.pi)
    x = x / (w + 1e-6) * (2 * math.pi)
    dim_t = temperature ** (2 * (np.arange(num_pos_feats) // 2) / num_pos_feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    # sin on the even indices, cos on the odd ones, interleaved
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _pos_table(h: int, w: int, c: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    # built once per size and device: a pageable copy to the card on every
    # call would wait for the device's queue to drain.  A normal tensor
    # even when first built under inference_mode, as ops/resize.py's cache
    with torch.inference_mode(False):
        pos = torch.from_numpy(sine_position_embedding(h, w, c // 2))
        return pos.reshape(1, h * w, c).to(device, dtype)


def _pos_tokens(h: int, w: int, c: int, like: torch.Tensor) -> torch.Tensor:
    """The (1, h*w, c) sine embedding in ``like``'s dtype and device."""
    return _pos_table(h, w, c, like.device, like.dtype)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, H*W, C), row-major positions."""
    return x.flatten(2).transpose(1, 2)


def _image(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> NCHW."""
    return tokens.transpose(1, 2).reshape(tokens.shape[0], -1, h, w) \
        .contiguous()


class AttnLayer(nn.Module):
    """Post-norm transformer layer: self-attention, cross-attention, FFN,
    positional embeddings added to the queries and keys (reference
    geotr_core.py:337-478; only the first of its two cross-attentions is
    ever reached)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = CrossAttention(d_model, nhead)
        self.multihead_attn_0 = CrossAttention(d_model, nhead)
        self.norm1 = LayerNorm(d_model)
        self.norm2_0 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, tgt, memory, pos, memory_pos):
        q = tgt + pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt2 = self.multihead_attn_0(tgt + pos, memory + memory_pos, memory)
        tgt = self.norm2_0(tgt + tgt2)
        y = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + y)


class TransEncoder(nn.Module):
    def __init__(self, num_layers: int = 6, hidden_dim: int = 256):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layers_{i}", AttnLayer(hidden_dim))

    def forward(self, imgf: torch.Tensor) -> torch.Tensor:
        n, c, h, w = imgf.shape
        pos = _pos_tokens(h, w, c, imgf)
        x = _tokens(imgf)
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, x, pos, pos)
        return _image(x, h, w)


class TransDecoder(nn.Module):
    def __init__(self, num_layers: int = 6, hidden_dim: int = 256,
                 num_tokens: int = 1296):
        super().__init__()
        self.num_layers = num_layers
        self.query_embed = nn.Parameter(torch.zeros(num_tokens, hidden_dim))
        for i in range(num_layers):
            setattr(self, f"layers_{i}", AttnLayer(hidden_dim))

    def forward(self, imgf: torch.Tensor) -> torch.Tensor:
        n, c, h, w = imgf.shape
        pos = _pos_tokens(h, w, c, imgf)
        query = self.query_embed.to(imgf.dtype)
        x = query[None].expand(n, -1, -1)
        mem = _tokens(imgf)
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, mem, pos, pos)
        return _image(x, h, w)


class UpdateBlock(nn.Module):
    """RAFT flow head + convex-upsampling mask head (geotr_core.py:553-568)."""

    def __init__(self, hidden_dim: int = 256):
        super().__init__()
        self.mask_0 = nn.Conv2d(hidden_dim, 256, 3, padding=1)
        self.mask_2 = nn.Conv2d(256, 64 * 9, 1)
        self.flow_head_conv1 = nn.Conv2d(hidden_dim, 256, 3, padding=1)
        self.flow_head_conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, imgf: torch.Tensor, coords1: torch.Tensor):
        """NCHW features, (N, H, W, 2) f32 coordinates -> (the (N, 576, H,
        W) upsampling mask, coords1 + the flow head's offsets, f32)."""
        mask = 0.25 * conv1x1_f32(self.mask_2, _conv(self.mask_0, imgf, True))
        f = _conv(self.flow_head_conv1, imgf, True)
        dflow = _conv(self.flow_head_conv2, f)
        return mask, coords1 + dflow.permute(0, 2, 3, 1).float()


def coords_grid_pixels(n: int, h: int, w: int,
                       device=None) -> torch.Tensor:
    """(N, H, W, 2) f32 absolute pixel coordinates, x first (reference
    ``coords_grid``, geotr_core.py:571-574)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(n, h, w, 2)


def convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """Convex-combination 8x upsampling (reference geotr_core.py:713-724):
    flow (N, H, W, 2), mask NCHW (N, 576, H, W) -> (N, 8H, 8W, 2) in the
    flow's dtype (the mask's softmax in its own dtype, then promoted, as
    JAX promotes it)."""
    n, h, w, _ = flow.shape
    m = mask.permute(0, 2, 3, 1).reshape(n, h, w, 9, 8, 8)
    m = torch.softmax(m, dim=3).to(flow.dtype)
    # the 3x3 neighbourhoods of 8 * flow (zero padding), F.unfold's order
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([fp[:, dy:dy + h, dx:dx + w]
                           for dy in range(3) for dx in range(3)], dim=3)
    up = torch.einsum("nhwkpq,nhwkc->nhpwqc", m, patches)
    return up.reshape(n, 8 * h, 8 * w, 2)


class GeoTr(nn.Module):
    """Coarse dewarper: a P^2 image -> the backward map's offsets at P^2,
    in pixels of the (P/8)^2 grid times 8 (reference geotr_core.py:
    690-740); P = 288 in production, (P/8)^2 = 1296 tokens."""

    def __init__(self, num_attn_layers: int = 6, hidden_dim: int = 256,
                 image_size: int = 288):
        super().__init__()
        self.fnet = BasicEncoder(hidden_dim)
        self.TransEncoder = TransEncoder(num_attn_layers, hidden_dim)
        self.TransDecoder = TransDecoder(num_attn_layers, hidden_dim,
                                         (image_size // 8) ** 2)
        self.update_block = UpdateBlock(hidden_dim)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        n, _, h, w = image.shape
        fmap = F.relu(self.fnet(image))
        fmap = self.TransDecoder(self.TransEncoder(fmap))
        coords0 = coords_grid_pixels(n, h // 8, w // 8, image.device)
        mask, coords1 = self.update_block(fmap, coords0)
        return convex_upsample_flow(coords1 - coords0, mask)


class GeoTrSegInf(nn.Module):
    """Inference wrapper (geotr_core.py:997-1019): the soft U2NetP mask
    times the image -> GeoTr's backward map, and the soft mask upsampled
    to ``mask_size`` (512 in production).  Without ``full`` (serving under
    ``use_init_flow=False``) there is no GeoTr: the map is None."""

    def __init__(self, mask_size: int = 512, full: bool = False,
                 image_size: int = 288):
        super().__init__()
        self.mask_size = mask_size
        self.msk = U2NetP(3, 1)
        self.GeoTr = GeoTr(image_size=image_size) if full else None

    @property
    def absent_subtrees(self) -> Tuple[str, ...]:
        """Subtrees of a weight file this module does not hold: the weight
        bridge skips them (``training/convert.py:variables_to_state_dict``)."""
        return () if self.GeoTr is not None else ("GeoTr.",)

    def _mask_up(self, msk: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(msk, (self.mask_size, self.mask_size), True)

    def forward(self, x: torch.Tensor
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(N, 3, P, P) -> (the (N, P, P, 2) map or None, the soft mask
        (N, 1, mask_size, mask_size))."""
        # the mask branch replays a CUDA graph where enabled
        # (utils/graphs.py); GeoTr itself runs eagerly
        msk, up = graphs.call(self, self._mask_branch, x)
        bm = self.GeoTr(msk * x) if self.GeoTr is not None else None
        return bm, up

    def _mask_branch(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        msk = self.msk(x)[0]
        return msk, self._mask_up(msk)


class GeoTrSeg(GeoTrSegInf):
    """Training-time wrapper (geotr_core.py:962-982): the *hard* 0.5 mask
    times the image, and the hard mask upsampled."""

    def __init__(self, mask_size: int = 512, image_size: int = 288):
        super().__init__(mask_size, True, image_size)

    def forward(self, x):
        hard = (self.msk(x)[0] > 0.5).to(x.dtype)
        return self.GeoTr(hard * x), self._mask_up(hard)


class GeoTrSegWoMask(nn.Module):
    """Mask-free variant (geotr_core.py:1021-1040)."""

    def __init__(self, image_size: int = 288):
        super().__init__()
        self.GeoTr = GeoTr(image_size=image_size)

    def forward(self, x):
        return self.GeoTr(x), None


class GeoTr2(nn.Module):
    """DocTr as a denoiser (``train_mode='stage_1_doctr'``, reference
    geotr_core.py:612-685): cat[src_feat (64), x (2), init_flow (2)] at the
    latent size -> BasicEncoder2 (/2) -> TransEncoder and TransDecoder over
    (latent/2)^2 tokens -> the flow head and the convex 8x upsampling ->
    bilinear (align_corners) to the latent size, / 256.

    Upstream's ``GeoTr2.forward`` does not run as shipped (it reads an
    unset ``self.train_mode`` and calls its decoder without the query
    embedding; ``dvd_tpu/models/geotr.py:GeoTr2``).  This is
    ``dvd_tpu``'s reading of it: the decoder holds and takes its learned
    queries, and the 68-channel input reaches ``layer1_0`` through a 1x1
    projection.  ``t`` is not used, as upstream; upstream's second output
    (always None) is dropped.  K1 at Dh 32 (8 heads over 1024 tokens at
    latent 64), K2 at every stride-1 3x3 conv; the output f32."""

    def __init__(self, num_attn_layers: int = 6, hidden_dim: int = 256,
                 latent: int = 64, in_channels: int = 68):
        super().__init__()
        self.latent = latent
        self.fnet = BasicEncoder2(in_channels, hidden_dim)
        self.TransEncoder_0 = TransEncoder(num_attn_layers, hidden_dim)
        self.TransDecoder_0 = TransDecoder(num_attn_layers, hidden_dim,
                                           (latent // 2) ** 2)
        self.update_block = UpdateBlock(hidden_dim)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                src_feat: torch.Tensor, init_flow: torch.Tensor
                ) -> torch.Tensor:
        """x, init_flow (N, S, S, 2), src_feat (N, 64, S, S) -> the
        (N, S, S, 2) f32 flow."""
        dt = compute_dtype(self.update_block.mask_2.weight)
        h = torch.cat([src_feat, x.permute(0, 3, 1, 2),
                       init_flow.permute(0, 3, 1, 2)], dim=1).to(dt)
        fmap = F.relu(self.fnet(h.contiguous()))
        fmap = self.TransDecoder_0(self.TransEncoder_0(fmap)).to(dt)
        n, _, hh, ww = fmap.shape
        coords0 = coords_grid_pixels(n, hh, ww, fmap.device)
        mask, coords1 = self.update_block(fmap, coords0)
        bm = convex_upsample_flow(coords1 - coords0, mask)
        bm = resize_bilinear(bm.permute(0, 3, 1, 2), (self.latent,) * 2, True)
        return bm.permute(0, 2, 3, 1) / 256.0
