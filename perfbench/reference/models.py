"""The shipped serving networks in plain PyTorch: the DiT-S/2 denoiser
with its SATRN decoder (the 'para' cross-attention mode, the recurrent
stream, only the last block live as in the DvD reference), U^2-Net small
(Seg and the mask branch of GeoTrSegInf) and the text-line UNet.

Every convolution is ``F.conv2d``, every attention a matmul and a softmax,
every resize ``F.interpolate``; nothing here fuses, folds or caches.  The
module and parameter names are those of the served package, so one
state_dict loads into both.  Run in float32 with TF32 off
(``perfbench.serving.reference_precision``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def resize(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NCHW ``x``; identity at its own size."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def attention(q, k, v, scale):
    """softmax(q k^T * scale) v, (N, H, T, Dh)."""
    q, k, v = low(q), low(k), low(v)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(low(p), v)


def split_heads(x, h):
    n, t, d = x.shape
    return x.reshape(n, t, h, d // h).transpose(1, 2)


def merge_heads(x):
    n, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(n, t, h * dh)


class BatchNorm(nn.Module):
    """Frozen BatchNorm over channel ``dim`` (1 for NCHW, -1 for
    channel-last), the served package's leaf names."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, dim: int = -1, train: bool = False):
        shape = [1] * x.dim()
        shape[dim] = -1
        if train:
            # the batch's mean and biased variance E[x^2] - E[x]^2, kept
            # for the running statistics' update after the step
            dims = tuple(i for i in range(x.dim()) if i != dim % x.dim())
            mean, msq = x.mean(dims), (x * x).mean(dims)
            var = torch.clamp(msq - mean * mean, min=0.0)
            self.batch_stats = (mean.detach(), var.detach())
            inv = (self.scale / torch.sqrt(var + self.eps)).reshape(shape)
            return (x - mean.reshape(shape)) * inv + self.bias.reshape(shape)
        inv = (self.scale / torch.sqrt(self.var + self.eps)).reshape(shape)
        return (x - self.mean.reshape(shape)) * inv + self.bias.reshape(shape)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


def dropout(x, rate: float, gen):
    """Keep with probability 1 - rate (a uniform draw from ``gen``),
    scaled by 1 / (1 - rate)."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


DROPOUT = 0.1     # the SATRN decoder's, in training


def layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at e4m3's 448), returned in float32; the gradient passes
    through the rounding unchanged."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


# the precision of every product's operands (convolutions, linear maps,
# attention): None (float32) or "fp8", the control's
OPERANDS = {"round": None}


def low(t: torch.Tensor) -> torch.Tensor:
    return fp8(t) if OPERANDS["round"] == "fp8" else t


class Linear(nn.Linear):
    """``nn.Linear`` with its operands in ``OPERANDS``' precision."""

    def forward(self, x):
        return F.linear(low(x), low(self.weight), self.bias)


def conv(c: nn.Conv2d, x, bn=None, relu=False):
    y = F.conv2d(low(x), low(c.weight), c.bias, padding=c.padding,
                 dilation=c.dilation, stride=c.stride, groups=c.groups)
    if bn is not None:
        y = bn(y, dim=1)
    return torch.relu(y) if relu else y


# ------------------------------------------------------------ U^2-Net small
def pool_ceil(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def upsample_like(src, tar):
    return resize(src, tar.shape[-2:], False)


class REBNCONV(nn.Module):
    def __init__(self, cin, cout, dirate=1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(cin, cout, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = BatchNorm(cout)

    def forward(self, x):
        return conv(self.conv_s1, x, self.bn_s1, True)


class RSU(nn.Module):
    def __init__(self, height, cin, mid, cout):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(cin, cout)
        self.rebnconv1 = REBNCONV(cout, mid)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid, mid))
        setattr(self, f"rebnconv{height}", REBNCONV(mid, mid, 2))
        for i in range(height - 1, 0, -1):
            setattr(self, f"rebnconv{i}d",
                    REBNCONV(2 * mid, cout if i == 1 else mid))

    def forward(self, x):
        hxin = self.rebnconvin(x)
        enc = [self.rebnconv1(hxin)]
        for i in range(2, self.height):
            enc.append(getattr(self, f"rebnconv{i}")(pool_ceil(enc[-1])))
        d = getattr(self, f"rebnconv{self.height}")(enc[-1])
        for i in range(self.height - 1, 0, -1):
            d = getattr(self, f"rebnconv{i}d")(torch.cat([d, enc[i - 1]], 1))
            if i > 1:
                d = upsample_like(d, enc[i - 2])
        return d + hxin


class RSU4F(nn.Module):
    def __init__(self, cin, mid, cout):
        super().__init__()
        self.rebnconvin = REBNCONV(cin, cout)
        self.rebnconv1 = REBNCONV(cout, mid)
        self.rebnconv2 = REBNCONV(mid, mid, 2)
        self.rebnconv3 = REBNCONV(mid, mid, 4)
        self.rebnconv4 = REBNCONV(mid, mid, 8)
        self.rebnconv3d = REBNCONV(2 * mid, mid, 4)
        self.rebnconv2d = REBNCONV(2 * mid, mid, 2)
        self.rebnconv1d = REBNCONV(2 * mid, cout)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat([h4, h3], 1))
        d2 = self.rebnconv2d(torch.cat([d3, h2], 1))
        return self.rebnconv1d(torch.cat([d2, h1], 1)) + hxin


class U2NetP(nn.Module):
    """-> (sigmoid(d0), hx6, hx5d, hx4d, hx3d, hx2d, hx1d)."""

    def __init__(self):
        super().__init__()
        self.stage1 = RSU(7, 3, 16, 64)
        self.stage2 = RSU(6, 64, 16, 64)
        self.stage3 = RSU(5, 64, 16, 64)
        self.stage4 = RSU(4, 64, 16, 64)
        self.stage5 = RSU4F(64, 16, 64)
        self.stage6 = RSU4F(64, 16, 64)
        self.stage5d = RSU4F(128, 16, 64)
        self.stage4d = RSU(4, 128, 16, 64)
        self.stage3d = RSU(5, 128, 16, 64)
        self.stage2d = RSU(6, 128, 16, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        for i in range(1, 7):
            setattr(self, f"side{i}", nn.Conv2d(64, 1, 3, padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x):
        s1 = self.stage1(x)
        s2 = self.stage2(pool_ceil(s1))
        s3 = self.stage3(pool_ceil(s2))
        s4 = self.stage4(pool_ceil(s3))
        s5 = self.stage5(pool_ceil(s4))
        s6 = self.stage6(pool_ceil(s5))
        d5 = self.stage5d(torch.cat([upsample_like(s6, s5), s5], 1))
        d4 = self.stage4d(torch.cat([upsample_like(d5, s4), s4], 1))
        d3 = self.stage3d(torch.cat([upsample_like(d4, s3), s3], 1))
        d2 = self.stage2d(torch.cat([upsample_like(d3, s2), s2], 1))
        d1 = self.stage1d(torch.cat([upsample_like(d2, s1), s1], 1))
        sides = [conv(getattr(self, f"side{i}"), d)
                 for i, d in enumerate((d1, d2, d3, d4, d5, s6), start=1)]
        sides = [sides[0]] + [upsample_like(o, s1) for o in sides[1:]]
        d0 = torch.sigmoid(conv(self.outconv, torch.cat(sides, 1)))
        return d0, s6, d5, d4, d3, d2, d1


class Seg(nn.Module):
    def __init__(self):
        super().__init__()
        self.msk = U2NetP()

    def forward(self, x, mask=None):
        """-> (the image under the hard mask, the six side features, the
        soft mask d0); ``mask`` in place of the hard mask ``d0 > 0.5``."""
        d0, *pyramid = self.msk(x)
        keep = d0 > 0.5 if mask is None else mask
        return keep.to(x.dtype) * x, tuple(pyramid), d0


class GeoTrSegInf(nn.Module):
    """The mask branch alone (serving without ``use_init_flow``)."""

    def __init__(self, mask_size: int):
        super().__init__()
        self.mask_size = mask_size
        self.msk = U2NetP()

    def forward(self, x):
        return resize(self.msk(x)[0], (self.mask_size,) * 2, True)


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, mid=0):
        super().__init__()
        mid = mid or cout
        self.conv_0 = nn.Conv2d(cin, mid, 3, padding=1)
        self.bn_1 = BatchNorm(mid)
        self.conv_3 = nn.Conv2d(mid, cout, 3, padding=1)
        self.bn_4 = BatchNorm(cout)

    def forward(self, x):
        return conv(self.conv_3, conv(self.conv_0, x, self.bn_1, True),
                    self.bn_4, True)


class TextLineUNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.inc = DoubleConv(3, 64)
        self.down1 = DoubleConv(64, 128)
        self.down2 = DoubleConv(128, 256)
        self.down3 = DoubleConv(256, 512)
        self.down4 = DoubleConv(512, 512)
        self.up1 = DoubleConv(1024, 256, 512)
        self.up2 = DoubleConv(512, 128, 256)
        self.up3 = DoubleConv(256, 64, 128)
        self.up4 = DoubleConv(128, 64, 64)
        self.outc = nn.Conv2d(64, 1, 1)

    def forward(self, x):
        """-> the 64-channel features before ``outc``."""
        x1 = self.inc(x)
        x2 = self.down1(F.max_pool2d(x1, 2))
        x3 = self.down2(F.max_pool2d(x2, 2))
        x4 = self.down3(F.max_pool2d(x3, 2))
        y = self.down4(F.max_pool2d(x4, 2))
        for skip, name in ((x4, "up1"), (x3, "up2"), (x2, "up3"), (x1, "up4")):
            y = resize(y, (y.shape[2] * 2, y.shape[3] * 2), True)
            y = getattr(self, name)(torch.cat([skip, y], 1))
        return y


# --------------------------------------------------------------------- DiT
def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """MAE's fixed 2D sin-cos table (grid^2, dim), h-embedding first."""

    def one_d(d, pos):
        omega = 1.0 / 10000.0 ** (np.arange(d // 2, dtype=np.float64) / (d / 2))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(g, g), axis=0)
    table = np.concatenate([one_d(dim // 2, mesh[0]), one_d(dim // 2, mesh[1])],
                           axis=1)
    return torch.from_numpy(table.astype(np.float32))


def satrn_table(n: int, d: int) -> torch.Tensor:
    """(n, d): pos / 10000^(2*(j//2)/d), sin on even columns, cos on odd."""
    j = np.arange(d)
    table = np.arange(n)[:, None].astype(np.float64) \
        / np.power(10000.0, 2 * (j // 2) / d)[None, :]
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return torch.from_numpy(table.astype(np.float32))


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class PatchEmbed(nn.Module):
    def __init__(self, cin, patch, dim):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, patch)

    def forward(self, x):
        return conv(self.proj, x).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden, freq=256):
        super().__init__()
        self.freq = freq
        self.mlp_0 = Linear(freq, hidden)
        self.mlp_2 = Linear(hidden, hidden)

    def forward(self, t):
        return self.mlp_2(F.silu(self.mlp_0(timestep_embedding(t, self.freq))))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, q, k, v):
        h = self.heads
        q, k, v = (split_heads(p(x), h) for p, x in
                   ((self.q_proj, q), (self.k_proj, k), (self.v_proj, v)))
        return self.out_proj(merge_heads(attention(
            q, k, v, 1.0 / math.sqrt(q.shape[-1]))))


class SelfAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        q, k, v = (split_heads(p, self.heads)
                   for p in self.qkv(x).chunk(3, dim=-1))
        return self.proj(merge_heads(attention(
            q, k, v, 1.0 / math.sqrt(q.shape[-1]))))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """adaLN-Zero block, 'para': the shared cross-attention against each
    stream, each branch then through self-attention and the MLP."""

    def __init__(self, dim, heads, mlp_ratio=4.0):
        super().__init__()
        self.adaLN_modulation_1 = Linear(dim, 6 * dim)
        self.cross_attn = CrossAttention(dim, heads)
        self.attn = SelfAttention(dim, heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, t_emb, streams):
        sm, cm, gm, sf, cf, gf = self.adaLN_modulation_1(
            F.silu(t_emb)).chunk(6, dim=-1)
        xq = layer_norm(x)
        outs = []
        for s in streams:
            xi = x + self.cross_attn(xq, s, s)
            xi = xi + gm[:, None] * self.attn(modulate(layer_norm(xi), sm, cm))
            outs.append(xi + gf[:, None] * self.mlp(
                modulate(layer_norm(xi), sf, cf)))
        return outs


class ConvBNReLU(nn.Module):
    """Channel-last: 1x1 (a linear map) or depthwise 3x3, no bias."""

    def __init__(self, cin, cout, kernel=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, train=False):
        y = conv(self.conv, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.relu(self.bn(y, train=train))


class LocalityAwareFeedforward(nn.Module):
    def __init__(self, d_in, d_hid):
        super().__init__()
        self.conv1 = ConvBNReLU(d_in, d_hid)
        self.depthwise_conv = ConvBNReLU(d_hid, d_hid, 3, d_hid)
        self.conv2 = ConvBNReLU(d_hid, d_in)

    def forward(self, x, train=False):
        return self.conv2(self.depthwise_conv(self.conv1(x, train), train),
                          train)


class Adaptive2DPositionalEncoding(nn.Module):
    def __init__(self, d, n):
        super().__init__()
        self.register_buffer("table", satrn_table(n, d), persistent=False)
        for name in ("h_scale", "w_scale"):
            setattr(self, f"{name}_0", nn.Conv2d(d, d, 1))
            setattr(self, f"{name}_2", nn.Conv2d(d, d, 1))

    def _scale(self, name, pooled):
        c0, c2 = getattr(self, f"{name}_0"), getattr(self, f"{name}_2")
        y = torch.relu(F.linear(pooled, c0.weight.flatten(1), c0.bias))
        return torch.sigmoid(F.linear(y, c2.weight.flatten(1), c2.bias))

    def forward(self, x, gen=None):
        _, h, w, _ = x.shape
        pooled = x.mean(dim=(1, 2))
        hs = self._scale("h_scale", pooled)[:, None, None, :]
        ws = self._scale("w_scale", pooled)[:, None, None, :]
        out = x + hs * self.table[:h][None, :, None, :] \
            + ws * self.table[:w][None, None, :, :]
        return out if gen is None else dropout(out, DROPOUT, gen)


class SATRNAttention(nn.Module):
    def __init__(self, heads, d_model, d_k):
        super().__init__()
        self.heads, self.d_k = heads, d_k
        self.linear_q = Linear(d_model, heads * d_k, bias=False)
        self.linear_k = Linear(d_model, heads * d_k, bias=False)
        self.linear_v = Linear(d_model, heads * d_k, bias=False)
        self.fc = Linear(heads * d_k, d_model, bias=False)

    def forward(self, x, gen=None):
        q, k, v = (split_heads(p(x), self.heads)
                   for p in (self.linear_q, self.linear_k, self.linear_v))
        out = self.fc(merge_heads(attention(q, k, v, 1.0 / self.d_k ** 0.5)))
        return out if gen is None else dropout(out, DROPOUT, gen)


class DecoderLayer(nn.Module):
    def __init__(self, d_model, d_inner, heads, d_k):
        super().__init__()
        self.norm1 = LayerNorm(d_model)
        self.attn = SATRNAttention(heads, d_model, d_k)
        self.norm2 = LayerNorm(d_model)
        self.feed_forward = LocalityAwareFeedforward(d_model, d_inner)

    def forward(self, x, h, w, gen=None):
        """``gen``: training (batch statistics, dropout drawn from it)."""
        n, t, c = x.shape
        x = x + self.attn(self.norm1(x), gen)
        return x + self.feed_forward(self.norm2(x).reshape(n, h, w, c),
                                     gen is not None).reshape(n, t, c)


class Decoder(nn.Module):
    def __init__(self, n_layers, heads, d_k, d_model, n_position, d_inner):
        super().__init__()
        self.n_layers = n_layers
        self.position_dec = Adaptive2DPositionalEncoding(d_model, n_position)
        for i in range(n_layers):
            setattr(self, f"layer_stack_{i}",
                    DecoderLayer(d_model, d_inner, heads, d_k))
        self.layer_norm = LayerNorm(d_model)

    def forward(self, feat, gen=None):
        n, h, w, c = feat.shape
        x = self.position_dec(feat, gen).reshape(n, h * w, c)
        for i in range(self.n_layers):
            x = getattr(self, f"layer_stack_{i}")(x, h, w, gen)
        return self.layer_norm(x)


class FinalLayer(nn.Module):
    def __init__(self, hidden, patch, cout, n_streams):
        super().__init__()
        self.n_streams = n_streams
        self.adaLN_modulation_1 = Linear(hidden, 2 * hidden)
        self.linear = Linear(hidden, patch * patch * cout)

    def forward(self, x, t_emb):
        shift, scale = self.adaLN_modulation_1(
            F.silu(t_emb.repeat(1, self.n_streams))).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm(x), shift, scale))


PYRAMID = (("level_0_conv0", 4, 64, False), ("level_1_conv0", 64, 64, True),
           ("level_2_conv0", 64, 128, False), ("level_2_conv1", 128, 128, True),
           ("level_3_conv0", 128, 256, False),
           ("level_3_conv1", 256, 256, False),
           ("level_3_conv2", 256, 256, True))


class ConditioningPyramid(nn.Module):
    """RGB + mask at the source size -> 256 channels at the latent size."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, _ in PYRAMID:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, x):
        for name, _, _, pool in PYRAMID:
            x = conv(getattr(self, name), x, relu=True)
            if pool:
                x = F.max_pool2d(x, 2, 2)
        return x


class DiT(nn.Module):
    """The shipped DiT: four streams (image, seg mask, text line,
    recurrent) through the last block, fused by the SATRN decoder."""

    def __init__(self, input_size, patch_size, hidden_size, depth, num_heads,
                 in_channels=2):
        super().__init__()
        self.patch, self.cin, self.depth = patch_size, in_channels, depth
        grid = input_size // patch_size
        self.register_buffer("pos", sincos_2d(hidden_size, grid)[None],
                             persistent=False)
        self.obs_embedder = PatchEmbed(in_channels, patch_size, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.pyramid = ConditioningPyramid()
        self.c_embedder = PatchEmbed(256, patch_size, hidden_size)
        self.m_embedder = PatchEmbed(384, patch_size, hidden_size)
        self.r_embedder = PatchEmbed(2 + 256, patch_size, hidden_size)
        self.l_embedder = PatchEmbed(64, patch_size, hidden_size)
        for i in range(depth):
            setattr(self, f"blocks_{i}", DiTBlock(hidden_size, num_heads))
        k = 4
        self.decoder = Decoder(6, 6, 64 * k, hidden_size * k, input_size // 2,
                               2048)
        self.final_layer2 = FinalLayer(hidden_size * k, patch_size,
                                       in_channels, k)

    def embed(self, name, x):
        return getattr(self, name)(x) + self.pos

    def forward(self, x, t, *, init_flow, init_feat, seed, src_feat,
                cond_tokens, msk6_tokens, line_tokens, remap=True, gen=None):
        """x, init_flow (N, S, S, 2); t (N,) timesteps, with ``remap`` the
        rescaled ones mapped to {0, 1, 2} as serving does; ``seed`` (N,)
        bool: the recurrent features start from ``src_feat``; ``gen``:
        training (the decoder's batch statistics, its dropout drawn from
        ``gen``).  -> (x0 flow, src_feat)."""
        tokens = self.embed("obs_embedder", x.permute(0, 3, 1, 2))
        if remap:
            t = torch.where(t > 600.0, torch.full_like(t, 2.0),
                            torch.where(t > 300.0, torch.full_like(t, 1.0), t))
        t_emb = self.t_embedder(t)
        init_feat = torch.where(seed.reshape(-1, 1, 1, 1), src_feat, init_feat)
        r = self.embed("r_embedder", torch.cat(
            [init_flow.permute(0, 3, 1, 2), init_feat], dim=1))
        block = getattr(self, f"blocks_{self.depth - 1}")
        outs = block(tokens, t_emb, (cond_tokens, msk6_tokens, line_tokens, r))
        fused = torch.cat(outs, dim=-1)
        n, tt, d = fused.shape
        g = int(round(tt ** 0.5))
        out = self.final_layer2(self.decoder(fused.reshape(n, g, g, d), gen),
                                t_emb)
        p, c = self.patch, self.cin
        pred = out.reshape(n, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(n, g * p, g * p, c)
        return pred + init_flow, src_feat
