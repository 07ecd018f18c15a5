"""End-to-end dewarping pipeline, DiT branch (port of
``dvd_tpu/evaluation/pipeline.py``).

1. 512^2 source -> 288^2 (align_corners=True) for the perception nets;
2. GeoTrSegInf mask branch: the soft document mask at 512^2 (``mask_cat``);
3. Seg (U2NetP): six decoder side features -> the 384-ch ``mask_y512``
   stream at the latent size, and the hard-masked image;
4. TextLineUNet over the hard-masked image -> the 64-ch ``line_msk``;
5. the DiT's conditioning pyramid and the c/m/l patch embedders, hoisted
   out of the DDIM loop; 3 DDIM steps x n_batch hypotheses;
6. the unwarp: upsample the flow to the page's size and grid_sample with
   ``((flow + base) * 2 - 1) * 0.987``, either at the source's own size
   (``unwarp_fixed``) or for a batch of pages of any native sizes padded
   into one canvas (``unwarp_native``, the dataset driver's).

Public entry points keep the JAX layout: ``dewarp_flow`` takes
(B, 512, 512, 3) in [0, 1] and returns (B, S, S, 2); the unwarps take
NHWC sources and flows.  Inside, images are NCHW.  The kernels sit under
stages 2-4 and the pyramid (K2), the DiT and SATRN attention (K1), the
feature re-warp (K3) and both unwarps (the fused unwarp, one launch).
Weights are drawn from a seed or loaded from converted files
(``training/checkpoint.py:maybe_load_pipeline_weights``).

Not ported yet (raise ``NotImplementedError``): the VGG conditioning
(``train_VGG=False``), GeoTr's flow (``use_init_flow``), the alternative
denoisers, int8 serving, and the 'seq'/'one' cross-attention modes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dvd_tpu_torch.config import DvDConfig
from dvd_tpu_torch.diffusion.sampler import ddim_sample_loop
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule
from dvd_tpu_torch.models.dit import (DiT, conditioning_pyramid_features,
                                      make_dit)
from dvd_tpu_torch.models.geotr import GeoTrSegInf
from dvd_tpu_torch.models.layers import seeded_init_
from dvd_tpu_torch.models.textline_unet import TextLineUNet
from dvd_tpu_torch.models.u2net import Seg, seg_pyramid_to_latent
from dvd_tpu_torch.ops.kernels.unwarp import native_grid, unwarp  # noqa: F401
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.utils.grids import UNWARP_SHRINK

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_config(cfg: DvDConfig) -> None:
    """Raise for the flags whose code paths are not ported yet."""
    m = cfg.model
    todo = []
    if m.train_mode not in ("stage_1_dit_cross", "stage_1_dit_cat"):
        todo.append(f"train_mode={m.train_mode!r} (alternative denoisers)")
    if not m.train_VGG:
        todo.append("train_VGG=False (VGG16 conditioning)")
    if m.use_init_flow:
        todo.append("use_init_flow=True (the full GeoTr)")
    if m.quantize != "none":
        todo.append(f"quantize={m.quantize!r} (int8 serving)")
    if m.separate_cross_attn != "para":
        todo.append(f"separate_cross_attn={m.separate_cross_attn!r}")
    if m.serve_cond_chunk:
        todo.append("serve_cond_chunk > 0")
    if m.compute_dtype not in DTYPES or m.param_dtype not in DTYPES:
        todo.append(f"compute_dtype={m.compute_dtype!r}, "
                    f"param_dtype={m.param_dtype!r}")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


@dataclasses.dataclass
class DewarpPipeline:
    """The four networks + the schedule, on one device."""

    cfg: DvDConfig
    dit: DiT
    seg: Seg
    line: TextLineUNet
    geotr: GeoTrSegInf
    sched: DiffusionSchedule
    device: torch.device
    dtype: torch.dtype   # compute dtype of every network

    @classmethod
    def create(cls, cfg: DvDConfig, device="cuda",
               generator: Optional[torch.Generator] = None,
               dit: Optional[DiT] = None,
               train: bool = False) -> "DewarpPipeline":
        """Build the networks for ``cfg`` on ``device`` (the card unless
        the caller asks for the CPU); with a (CPU) ``generator`` their
        weights are drawn from it (``seeded_init_``), else they keep
        torch's default init until weights are loaded.  ``dit`` replaces
        the config's DiT (tests use a narrow one).  With ``train`` the DiT
        keeps ``model.param_dtype`` parameters that require gradients (the
        training step computes in ``compute_dtype`` under autocast), and
        drawn weights start its adaLN and final layers at zero, as the
        reference's training init; the aux nets stay frozen either way."""
        check_config(cfg)
        m = cfg.model
        device = torch.device(device)
        if dit is None:
            dit = make_dit(m.dit_variant, input_size=m.image_size,
                           in_channels=m.in_channels, tv=m.time_variant,
                           chain_blocks=m.chain_blocks,
                           with_mask=not m.use_gt_mask,
                           with_line=m.use_line_mask and not m.use_gt_mask)
        nets = dict(dit=dit, seg=Seg(m.source_size), line=TextLineUNet(),
                    geotr=GeoTrSegInf(m.source_size))
        if generator is not None:
            for name, net in nets.items():
                seeded_init_(net, generator, zero_init=train and name == "dit")
        sched = make_schedule(steps=cfg.diffusion.diffusion_steps,
                              schedule_name=cfg.diffusion.noise_schedule,
                              respacing=cfg.diffusion.timestep_respacing,
                              rescale_timesteps=cfg.diffusion.rescale_timesteps,
                              device=device)
        # frozen (eval, no grad).  For serving the DiT is stored in the
        # compute dtype; the aux nets keep f32 weights and cast them, with
        # BN folded, once per weight set (fold_conv_bn)
        dtype = DTYPES[m.compute_dtype]
        nets["dit"].to(device, DTYPES[m.param_dtype] if train else dtype)
        for net in nets.values():
            net.to(device).eval().requires_grad_(False)
        if train:
            nets["dit"].requires_grad_(True)
        return cls(cfg=cfg, sched=sched, device=device, dtype=dtype, **nets)

    # ------------------------------------------------------ conditioning
    def build_conditioning(self, source512: torch.Tensor):
        """(B, 512, 512, 3) in [0, 1] -> (cond, init_flow, init_feat): the
        conditioning dict (NCHW tensors) and the zero recurrent state."""
        m = self.cfg.model
        s, per = m.image_size, m.perception_size
        x = source512.to(self.device, torch.float32).permute(0, 3, 1, 2)
        x = x.contiguous()
        b = x.shape[0]
        xa = resize_bilinear(x, (per, per), True).to(self.dtype).contiguous()
        cond = {"y512": x, "mask_cat": self.geotr(xa)}
        if not m.use_gt_mask:
            mskx, _, pyramid = self.seg(xa)
            cond["mask_y512"] = seg_pyramid_to_latent(pyramid, s)
            if m.use_line_mask:
                line_feat, _ = self.line(mskx)
                cond["line_msk"] = resize_bilinear(line_feat, (s, s), False)
        init_flow = torch.zeros((b, s, s, 2), device=self.device)
        init_feat = torch.zeros((b, 256, s, s), device=self.device)
        return cond, init_flow, init_feat

    # ---------------------------------------------------------- sampling
    def _hoist_pyramid(self, cond: Dict) -> Dict:
        """Run the DiT's conditioning pyramid once, outside the DDIM loop,
        and feed it through the ``src_feat`` bypass (its input is constant
        across steps and hypotheses).  y512/mask_cat are then unused."""
        out = dict(cond)
        y512, mask_cat = out.pop("y512"), out.pop("mask_cat", None)
        out["src_feat"] = conditioning_pyramid_features(
            self.dit.pyramid, y512, mask_cat, self.cfg.model.image_size,
            self.dit.dtype)
        return out

    def _hoist_stream_tokens(self, cond: Dict) -> Dict:
        """Embed the c/m/l streams once per image batch, before the
        hypotheses are tiled."""
        out = dict(cond)
        out.update(self.dit.embed_stream_tokens(
            feat=out["src_feat"], mask_y512=out.pop("mask_y512", None),
            line_msk=out.pop("line_msk", None)))
        return out

    def model_fn(self, x, t, cond, *, init_flow, init_feat, seed_init_feat,
                 remap_timesteps):
        return self.dit(
            x, t, init_flow=init_flow, init_feat=init_feat,
            src_feat=cond["src_feat"], cond_tokens=cond.get("cond_tokens"),
            msk6_tokens=cond.get("msk6_tokens"),
            line_tokens=cond.get("line_tokens"),
            seed_init_feat=seed_init_feat, remap_timesteps=remap_timesteps)

    def sampling_impl(self, cond: Dict, init_flow: torch.Tensor,
                      init_feat: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      init_noise: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Diffusion stage (conditioning precomputed) -> (B, S, S, 2).
        ``init_noise`` pins x_T; otherwise it is drawn from ``generator``
        (a generator on the pipeline's device)."""
        tv = bool(self.cfg.model.time_variant)
        cond = self._hoist_stream_tokens(self._hoist_pyramid(cond))
        d = self.cfg.diffusion
        return ddim_sample_loop(
            self.model_fn, self.sched, cond, init_flow,
            init_feat if tv else None, latent_size=self.cfg.model.image_size,
            n_batch=d.n_batch, time_variant=tv, eta=d.eta,
            clip_denoised=d.clip_denoised, generator=generator,
            init_noise=init_noise).flow

    @torch.inference_mode()
    def dewarp_flow(self, source512: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    init_noise: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """(B, 512, 512, 3) in [0, 1] -> (B, S, S, 2) offset field in
        [-1, 1]."""
        cond, init_flow, init_feat = self.build_conditioning(source512)
        return self.sampling_impl(cond, init_flow, init_feat, generator,
                                  init_noise)


@torch.inference_mode()
def unwarp_fixed(source: torch.Tensor, flow: torch.Tensor,
                 shrink: float = UNWARP_SHRINK) -> torch.Tensor:
    """Unwarp (B, H, W, C) ``source`` at its own size with the (B, S, S, 2)
    ``flow``: bilinear flow upsample (align_corners=True), the grid
    ``((flow + base) * 2 - 1) * shrink``, then K3's zero-padded gather; the
    result in the source's dtype.  Any H x W (the TPU gate's tiling rules
    do not apply).  One launch of the fused unwarp on a card
    (``ops/kernels/unwarp.py``)."""
    return unwarp(source, flow, None, shrink).to(source.dtype)


@torch.inference_mode()
def unwarp_native(source_padded: torch.Tensor, hw: torch.Tensor,
                  flow: torch.Tensor, shrink: float = UNWARP_SHRINK
                  ) -> torch.Tensor:
    """Unwarp a batch of pages of any native sizes inside one (P, P)
    canvas (port of ``dvd_tpu/evaluation/pipeline.py:unwarp_native``, the
    reference's post-processing ``evaluation.py:300-318``).

    ``source_padded`` (B, P, P, C), uint8 or float, holds each page at
    the top left; ``hw`` (B, 2) int gives each page's true (h, w);
    ``flow`` (B, S, S, 2) is the offset field, any float dtype (cast to
    f32).  Returns (B, P, P, C) f32 in the source's value range, K3's
    zero-padded gather at the :func:`native_grid` coordinates; pixels
    beyond (h, w) are don't-care.  One call serves every page size: on a
    card it is one launch of the fused unwarp (``ops/kernels/unwarp.py``),
    on the CPU the plain composition."""
    return unwarp(source_padded, flow, hw, shrink)
