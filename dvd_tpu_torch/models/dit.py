"""The DvD coordinate-denoising DiT (port of ``dvd_tpu/models/dit.py``;
reference ``cross_model.py``).

- private conditioning pyramid over RGB+mask at 512^2 -> 256 ch at /8; its
  3x3 convs run through K2 (scale 1, bias = conv bias, ReLU);
- five patch embedders: noisy flow (2 ch), recurrent state r = init_flow ++
  init_feat (258 ch), image cond (256), seg-mask pyramid (384), text-line
  features (64);
- DiT blocks with shared cross-attention applied in parallel ('para')
  against the conditioning streams, each branch then through the shared
  adaLN-zero self-attention + MLP; 'para' streams concatenated
  channel-wise, fused by the SATRN decoder, then an adaLN final layer with
  the timestep embedding tiled per stream;
- or (``separate_cross_attn``) one token stream through chained blocks:
  'seq' cross-attends to the seg-mask, image and text-line streams in turn
  (``cross_obs_attn``, ``cross_attn``, ``cross_attn_act``), 'one' to the
  image stream alone; then an adaLN final layer (``final_layer``), no
  decoder;
- output ``x + init_flow`` and the conditioning features, which the
  sampler re-warps between DDIM steps.

Reference quirks kept (README "Reference-parity notes"): the dead-block
quirk (``chain_blocks=False``: every block reads the original tokens and
only the last one's output survives, so only the last block runs) and the
sampling-time timestep remap (t > 600 -> 2, t > 300 -> 1).
``chain_blocks=True`` runs every block, each reading the mean of the
previous block's streams ('para'), as ``dvd_tpu``'s chained DiT does.

Routed experts (``DiT-MoE-*`` variants, ``moe``): every block's MLP is
DiT-MoE's sparse MoE layer (``models/moe.py``), fed the tokens of all the
block's streams in one call.  Served only: int8, training and tensor
parallelism refuse it.

adaLN-Zero's elementwise passes around each sublayer (the pre-norm
``modulate(layer_norm(x), shift, scale)``, the gated residual ``x + gate
* y``; the unmodulated norms; the final layer's pre-norm) go through
``ops/kernels/adaln.py``: one kernel launch each on a card (under
autograd, a backward through the plain expressions), their plain twins
(the same expressions) on the CPU.

Spans (``utils/trace.py``): ``dvd.dit.blocks`` around the blocks that run
(attributes ``blocks``, ``streams``, ``tokens``) and, in 'para',
``dvd.dit.decoder`` around the SATRN decoder and ``final_layer2``
(``width``, the fused streams' width); a MoE block's ``dvd.dit.moe``
spans (``models/moe.py``).

Layout: flows (N, S, S, 2) channel-last (the sampler's and grid_sample's
grid layout); images and feature maps NCHW; tokens (N, T, D).

int8 serving (``quant``, ``dvd_tpu``'s ``model.quantize="int8"``): the
live block's attention, cross-attention and MLP projections and the SATRN
decoder's projections and 1x1 convs are W8A8 (``ops/quant.py``); the
embedders, the timestep MLP, adaLN, the conditioning pyramid and
``final_layer2`` stay in floating point.  :meth:`DiT.int8_layers` lists
the quantized layers, whose weights serving keeps in f32.

Dtypes: the DiT computes in its weights' dtype (serving stores it in the
compute dtype), or, under ``torch.autocast``, in the autocast dtype with
f32 weights (training keeps f32 parameters and computes in bf16, as
flax's ``dtype``/``param_dtype``).  ``train=True`` runs the SATRN decoder
in train mode (batch-statistics BN, dropout from ``generator``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvd_tpu_torch.models import satrn
from dvd_tpu_torch.models.moe import MoE, MoESpec
from dvd_tpu_torch.models.layers import (CrossAttention, Mlp, PatchEmbed,
                                         SelfAttention, TimestepEmbedder,
                                         compute_dtype, conv3x3_folded,
                                         get_2d_sincos_pos_embed)
from dvd_tpu_torch.ops.kernels.adaln import gate_residual, ln_modulate
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.utils import trace
from dvd_tpu_torch.utils.dtypes import at_least_f32

# (name, Cin, Cout, maxpool after) for latent 64/32/16 (reference
# cross_model.py:18-95; latent 128 drops level_3_conv2 and the last pool)
PYRAMID_LAYERS = (
    ("level_0_conv0", 4, 64, False),
    ("level_1_conv0", 64, 64, True),
    ("level_2_conv0", 64, 128, False),
    ("level_2_conv1", 128, 128, True),
    ("level_3_conv0", 128, 256, False),
    ("level_3_conv1", 256, 256, False),
    ("level_3_conv2", 256, 256, True),
)


class ConditioningPyramid(nn.Module):
    """4 ch (RGB + mask) 512^2 -> 256 ch at the latent size: 3x3 conv + ReLU
    stages (K2) with 2x2 max pools between levels."""

    def __init__(self, input_size: int = 64, in_ch: int = 4):
        super().__init__()
        if input_size not in (16, 32, 64, 128):
            raise ValueError(f"unsupported latent size {input_size}")
        self.layers = PYRAMID_LAYERS if input_size != 128 else \
            PYRAMID_LAYERS[:5] + (("level_3_conv1", 256, 256, False),)
        for name, cin, cout, _ in self.layers:
            setattr(self, name, nn.Conv2d(in_ch if name == "level_0_conv0"
                                          else cin, cout, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NCHW
        for name, _, _, pool in self.layers:
            x = conv3x3_folded(getattr(self, name), None, x, True)
            if pool:
                x = F.max_pool2d(x, 2, 2)
        return x


def conditioning_pyramid_features(pyramid: ConditioningPyramid,
                                  y512: torch.Tensor,
                                  mask_cat: Optional[torch.Tensor],
                                  input_size: int,
                                  dtype: torch.dtype) -> torch.Tensor:
    """mask concat -> ConditioningPyramid -> 16/32 resize: what the
    ``src_feat`` bypass receives (NCHW in, NCHW out)."""
    y = y512 if mask_cat is None else torch.cat([y512, mask_cat], dim=1)
    feat = pyramid(y.to(dtype).contiguous())
    if input_size in (16, 32):
        feat = resize_bilinear(feat, (input_size, input_size), True)
    return feat


MODES = ("para", "seq", "one")


class DiTBlock(nn.Module):
    """adaLN-Zero DiT block.  'para': the shared cross-attention against
    each conditioning stream in parallel, each branch then through the
    shared self-attention + MLP; 'seq': cross-attention to the seg-mask,
    image and text-line streams in turn, then the backbone; 'one': to the
    image stream alone.

    With ``moe`` the backbone's MLP is DiT-MoE's routed-expert layer
    (``models/moe.py``, module ``moe``): the streams' self-attention runs
    branch by branch as in the dense block, then one call of the layer
    routes every stream's tokens together, so that each expert's GEMM
    sees the whole load."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, quant: bool = False,
                 mode: str = "para", moe: Optional[MoESpec] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"separate_cross_attn={mode!r}, not in {MODES}")
        self.mode = mode
        self.adaLN_modulation_1 = nn.Linear(hidden_size, 6 * hidden_size)
        self.cross_attn = CrossAttention(hidden_size, num_heads, quant)
        if mode == "seq":
            self.cross_obs_attn = CrossAttention(hidden_size, num_heads, quant)
            self.cross_attn_act = CrossAttention(hidden_size, num_heads, quant)
        self.attn = SelfAttention(hidden_size, num_heads, quant)
        if moe is None:
            self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                           hidden_size, quant)
        else:
            self.moe = MoE(hidden_size, moe)

    def forward(self, x, t_emb, cond, msk6=None, msk_line=None, r=None):
        """The block's output streams: one per conditioning stream given
        ('para': cond, msk6, msk_line, r, those present), else one."""
        ada = self.adaLN_modulation_1(F.silu(t_emb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            ada.chunk(6, dim=-1)

        def attend(xi):
            return gate_residual(xi, gate_msa, self.attn(
                ln_modulate(xi, shift_msa, scale_msa)))

        def backbone(xi):
            xi = attend(xi)
            return gate_residual(xi, gate_mlp, self.mlp(
                ln_modulate(xi, shift_mlp, scale_mlp)))

        def routed(xs):
            """The MoE half of every stream, their tokens in one call: each
            stream's pre-norm written into its rows of one buffer."""
            h = xs[0].new_empty((len(xs) * xs[0].shape[0],) + xs[0].shape[1:])
            for xi, hi in zip(xs, h.chunk(len(xs))):
                ln_modulate(xi, shift_mlp, scale_mlp, out=hi)
            y = self.moe(h.reshape(-1, h.shape[-1])).view(h.shape)
            return tuple(gate_residual(xi, gate_mlp, yi)
                         for xi, yi in zip(xs, y.chunk(len(xs))))

        if self.mode == "para":
            xq = ln_modulate(x)
            branches = (x + self.cross_attn(xq, s, s)
                        for s in (cond, msk6, msk_line, r) if s is not None)
        else:
            branches = (self._cross(x, cond, msk6, msk_line),)
        if hasattr(self, "moe"):
            return routed([attend(xi) for xi in branches])
        # dense: each stream through the whole backbone in turn
        return tuple(backbone(xi) for xi in branches)

    def _cross(self, x, cond, msk6, msk_line):
        """'seq' and 'one''s cross-attention, in turn."""
        if self.mode == "seq":
            x = x + self.cross_obs_attn(ln_modulate(x), msk6, msk6)
            x = x + self.cross_attn(ln_modulate(x), cond, cond)
            return x + self.cross_attn_act(ln_modulate(x), msk_line, msk_line)
        return x + self.cross_attn(ln_modulate(x), cond, cond)


class FinalLayer(nn.Module):
    """adaLN final projection; the timestep embedding is tiled
    ``n_streams`` times (reference FinalLayer2)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int,
                 n_streams: int = 1):
        super().__init__()
        self.n_streams = n_streams
        t_dim = hidden_size // n_streams
        self.adaLN_modulation_1 = nn.Linear(t_dim * n_streams, 2 * hidden_size)
        self.linear = nn.Linear(hidden_size,
                                patch_size * patch_size * out_channels)

    def forward(self, x, t_emb):
        if self.n_streams > 1:
            t_emb = t_emb.repeat(1, self.n_streams)
        shift, scale = self.adaLN_modulation_1(F.silu(t_emb)).chunk(2, dim=-1)
        return self.linear(ln_modulate(x, shift, scale))


def unpatchify(x: torch.Tensor, patch: int, channels: int) -> torch.Tensor:
    """(N, T, p*p*C) -> channel-last (N, h*p, w*p, C), row-major patches."""
    n, t, _ = x.shape
    h = w = int(round(t ** 0.5))
    x = x.reshape(n, h, w, patch, patch, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * patch, w * patch, channels)


class DiT(nn.Module):
    """DvD conditioning DiT.

    ``with_mask`` / ``with_line`` say whether the seg-pyramid and text-line
    streams exist (``use_gt_mask=False`` / ``use_line_mask=True`` in the
    shipped config); with ``tv`` the recurrent stream makes four.
    ``separate_cross_attn`` is the blocks' mode: 'para' (the shipped one:
    the last block's streams fused by the SATRN decoder), 'seq' (needs the
    seg-mask and text-line streams) or 'one' (chained blocks, one stream,
    ``final_layer``).  Every embedder exists in every mode, as
    ``dvd_tpu``'s parameter tree has them; 'seq' and 'one' do not run the
    ones they do not read."""

    def __init__(self, input_size: int = 64, patch_size: int = 2,
                 in_channels: int = 2, hidden_size: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 time_freq_size: int = 256, tv: bool = True,
                 chain_blocks: bool = False, with_mask: bool = True,
                 with_line: bool = True, dropout: float = 0.1,
                 quant: bool = False, separate_cross_attn: str = "para",
                 moe: Optional[MoESpec] = None):
        super().__init__()
        if moe is not None and quant:
            raise NotImplementedError(
                "int8 (model.quantize='int8') of a DiT with routed experts "
                "is not ported")
        if separate_cross_attn == "seq" and not (with_mask and with_line):
            raise ValueError("separate_cross_attn='seq' cross-attends to the "
                             "seg-mask and text-line streams: needs both")
        self.input_size, self.patch_size = input_size, patch_size
        self.in_channels, self.hidden_size = in_channels, hidden_size
        self.depth, self.tv, self.chain_blocks = depth, tv, chain_blocks
        self.quant, self.mode = quant, separate_cross_attn
        self.moe_spec = moe
        grid = input_size // patch_size
        self.register_buffer("pos", torch.from_numpy(
            get_2d_sincos_pos_embed(hidden_size, grid))[None], persistent=False)

        self.obs_embedder = PatchEmbed(in_channels, patch_size, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size, time_freq_size)
        self.pyramid = ConditioningPyramid(input_size)
        self.c_embedder = PatchEmbed(256, patch_size, hidden_size)
        self.m_embedder = PatchEmbed(384, patch_size, hidden_size) \
            if with_mask else None
        self.r_embedder = PatchEmbed(2 + 256, patch_size, hidden_size) \
            if tv else None
        self.l_embedder = PatchEmbed(64, patch_size, hidden_size) \
            if with_line else None
        for i in range(depth):
            setattr(self, f"blocks_{i}",
                    DiTBlock(hidden_size, num_heads, mlp_ratio, quant,
                             separate_cross_attn, moe))
        if separate_cross_attn == "para":
            k = 1 + int(with_mask) + int(with_line) + int(tv)
            self.decoder = satrn.Decoder(
                n_layers=6, n_head=6, d_k=64 * k, d_v=64 * k,
                d_model=hidden_size * k, n_position=input_size // 2,
                d_inner=2048, dropout=dropout, quant=quant)
            self.final_layer2 = FinalLayer(hidden_size * k, patch_size,
                                           in_channels, n_streams=k)
        else:
            k = 1
            self.final_layer = FinalLayer(hidden_size, patch_size, in_channels)
        self.n_streams = k
        for name, layer in self.int8_layers():
            layer.qname = name      # named in int8_dense's shape errors

    def int8_layers(self):
        """(name, layer) of every layer that runs W8A8 under ``quant``
        (none without it): the blocks' and the decoder's projections and
        the decoder's 1x1 convs."""
        if not self.quant:
            return []
        owners = (CrossAttention, SelfAttention, Mlp, satrn.SATRNAttention)
        out = []
        for name, mod in self.named_modules():
            if isinstance(mod, owners) or (
                    isinstance(mod, satrn.ConvBNReLU) and mod.quant):
                out += [(f"{name}.{n}", c) for n, c in mod.named_children()
                        if isinstance(c, (nn.Linear, nn.Conv2d))]
        return out

    @property
    def final(self) -> FinalLayer:
        """The output projection: ``final_layer2`` after 'para''s decoder,
        else ``final_layer``."""
        return self.final_layer2 if self.mode == "para" else self.final_layer

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: autocast's when it is on for the weights'
        device, else the weights' own."""
        return compute_dtype(self.obs_embedder.proj.weight)

    def embed(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One patch embedder (+ pos): NCHW -> (N, T, D) in the DiT dtype."""
        return getattr(self, name)(x.to(self.dtype)) + self.pos.to(self.dtype)

    def embed_stream_tokens(self, feat=None, mask_y512=None, line_msk=None):
        """The step- and hypothesis-invariant c/m/l tokens, hoisted out of
        the DDIM loop by serving (``dvd_tpu`` ``embed_stream_tokens``);
        'one' reads the c tokens alone."""
        out = {}
        if feat is not None:
            out["cond_tokens"] = self.embed("c_embedder", feat)
        if self.mode == "one":
            return out
        if mask_y512 is not None:
            out["msk6_tokens"] = self.embed("m_embedder", mask_y512)
        if line_msk is not None:
            out["line_tokens"] = self.embed("l_embedder", line_msk)
        return out

    def forward(
        self,
        x: torch.Tensor,                        # (N, S, S, 2) noisy flow
        t: torch.Tensor,                        # (N,) model-facing timesteps
        *,
        init_flow: torch.Tensor,                # (N, S, S, 2)
        init_feat: Optional[torch.Tensor] = None,   # (N, 256, S, S)
        y512: Optional[torch.Tensor] = None,    # (N, 3, 512, 512)
        mask_cat: Optional[torch.Tensor] = None,    # (N, 1, 512, 512)
        mask_y512: Optional[torch.Tensor] = None,   # (N, 384, S, S)
        line_msk: Optional[torch.Tensor] = None,    # (N, 64, S, S)
        src_feat: Optional[torch.Tensor] = None,    # (N, 256, S, S) hoisted
        seed_init_feat: Optional[torch.Tensor] = None,  # (N,) bool: t == T-1
        remap_timesteps: bool = True,
        train: bool = False,
        generator: Optional[torch.Generator] = None,   # dropout, train only
        cond_tokens: Optional[torch.Tensor] = None,
        msk6_tokens: Optional[torch.Tensor] = None,
        line_tokens: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        tokens = self.embed("obs_embedder", x.permute(0, 3, 1, 2))
        if remap_timesteps:   # sampling-mode remap (cross_model.py:575-579)
            t = torch.where(t > 600.0, torch.full_like(t, 2.0),
                            torch.where(t > 300.0, torch.full_like(t, 1.0), t))
        t_emb = self.t_embedder(t)

        if src_feat is not None:
            feat = src_feat.to(dt)
        else:
            feat = conditioning_pyramid_features(
                self.pyramid, y512, mask_cat, self.input_size, dt)
        cond = cond_tokens.to(dt) if cond_tokens is not None \
            else self.embed("c_embedder", feat)
        msk6 = msk_line = r = None
        if self.mode != "one":     # 'one' reads the image stream alone
            if msk6_tokens is not None:
                msk6 = msk6_tokens.to(dt)
            elif mask_y512 is not None:
                msk6 = self.embed("m_embedder", mask_y512)
            if line_tokens is not None:
                msk_line = line_tokens.to(dt)
            elif line_msk is not None:
                msk_line = self.embed("l_embedder", line_msk)
        if self.tv:
            if init_feat is None:
                init_feat = torch.zeros_like(feat)
            # at t == T-1 the recurrent features are seeded from the current
            # pyramid output (cross_model.py:596-601)
            if seed_init_feat is not None:
                init_feat = torch.where(seed_init_feat.reshape(-1, 1, 1, 1),
                                        feat, init_feat.to(feat.dtype))
            if self.mode == "para":   # the recurrent stream is para's
                r_in = torch.cat([init_flow.permute(0, 3, 1, 2).to(dt),
                                  init_feat.to(dt)], dim=1)
                r = self.embed("r_embedder", r_in)

        if self.mode != "para":
            # one stream through every block in turn
            with trace.span("dvd.dit.blocks", blocks=self.depth, streams=1,
                            tokens=tokens.shape[1]):
                for i in range(self.depth):
                    (tokens,) = getattr(self, f"blocks_{i}")(
                        tokens, t_emb, cond, msk6, msk_line)
            out = self.final_layer(tokens, t_emb)
        else:
            live = range(self.depth) if self.chain_blocks else \
                (self.depth - 1,)
            with trace.span("dvd.dit.blocks", blocks=len(live),
                            streams=self.n_streams, tokens=tokens.shape[1]):
                # chained: each block reads the mean of the previous one's
                # streams; dead-block semantics: only the last block runs,
                # as only its output survives
                for i in live:
                    outs = getattr(self, f"blocks_{i}")(
                        tokens, t_emb, cond, msk6, msk_line, r)
                    if self.chain_blocks:
                        tokens = sum(outs) / len(outs)
            fused = torch.cat(outs, dim=-1)                  # (N, T, k*D)
            n, tt, d = fused.shape
            with trace.span("dvd.dit.decoder", width=d):
                g = int(round(tt ** 0.5))
                dec = self.decoder(fused.reshape(n, g, g, d), train,
                                   generator)
                out = self.final_layer2(dec, t_emb)
        pred = unpatchify(out, self.patch_size, self.in_channels)
        return (at_least_f32(pred) + at_least_f32(init_flow),
                at_least_f32(feat))


# size registry of dvd_tpu/models/dit.py (reference DiT_models2)
DIT_CONFIGS = {
    f"DiT-{name}/{p}": dict(depth=d, hidden_size=w, patch_size=p, num_heads=h)
    for name, d, w, h in (("XL", 28, 1152, 16), ("L", 24, 1024, 16),
                          ("B", 12, 768, 12), ("S", 12, 384, 6))
    for p in (2, 4, 8)
}
DIT_CONFIGS["DiT-mini"] = dict(depth=2, hidden_size=48, patch_size=2,
                               num_heads=3)   # CPU tests / smoke runs
# DiT-MoE (arXiv:2407.11633, github.com/feizc/DiT-MoE models.py): DiT-XL/2's
# blocks with 8 routed SwiGLU experts of 4 x 1152, 2 a token, and a shared
# one of 2 x 1152; the mini size for the CPU tests
DIT_CONFIGS["DiT-MoE-XL/2-8E2A"] = dict(DIT_CONFIGS["DiT-XL/2"],
                                        moe=MoESpec(8, 2, 4.0, 2.0))
DIT_CONFIGS["DiT-MoE-mini"] = dict(DIT_CONFIGS["DiT-mini"],
                                   moe=MoESpec(8, 2, 4.0, 2.0))


def is_moe_variant(variant: str) -> bool:
    """Whether ``variant``'s blocks hold routed experts."""
    return DIT_CONFIGS.get(variant, {}).get("moe") is not None


def make_dit(variant: str = "DiT-S/2", **kwargs) -> DiT:
    cfg = dict(DIT_CONFIGS[variant])
    cfg.update(kwargs)
    return DiT(**cfg)
