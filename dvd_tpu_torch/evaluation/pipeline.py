"""End-to-end dewarping pipeline (port of
``dvd_tpu/evaluation/pipeline.py``).  The production DiT's path:

1. 512^2 source -> 288^2 (align_corners=True) for the perception nets;
2. GeoTrSegInf: the soft document mask at 512^2 (``mask_cat``), and under
   ``use_init_flow`` GeoTr's backward map ``ref_bm / (288 - 1)`` resized
   (align_corners=True) to the latent size as ``init_flow`` (else zeros);
3. Seg (U2NetP): six decoder side features -> the 384-ch ``mask_y512``
   stream at the latent size, and the hard-masked image;
4. TextLineUNet over the hard-masked image -> the 64-ch ``line_msk``;
5. the image stream: the DiT's private conditioning pyramid, or under
   ``train_VGG=False`` the frozen VGG16 pyramid's level 3 (``c20_for_dit``,
   f32); either enters the DiT through its ``src_feat`` bypass, hoisted out
   of the DDIM loop with the c/m/l patch embedders; 3 DDIM steps x
   n_batch hypotheses through the DiT in its ``separate_cross_attn`` mode
   ('para', 'seq' or 'one');
6. the unwarp: upsample the flow to the page's size and grid_sample with
   ``((flow + base) * 2 - 1) * 0.987``, either at the source's own size
   (``unwarp_fixed``) or for a batch of pages of any native sizes padded
   into one canvas (``unwarp_native``, the dataset driver's).

Public entry points keep the JAX layout: ``dewarp_flow`` takes
(B, 512, 512, 3) in [0, 1] and returns (B, S, S, 2); the unwarps take
NHWC sources and flows.  Inside, images are NCHW.  The kernels sit under
stages 2-5 (K2; GeoTr's transformer and the DiT's and SATRN's attention
K1), the feature re-warp (K3) and both unwarps (the fused unwarp, one
launch).
Weights are drawn from a seed or loaded from converted files
(``training/checkpoint.py:maybe_load_pipeline_weights``).  Stages 2-5 and
the unwarp are spans of ``utils/trace.py``: ``dvd.cond`` (each
sub-network a ``dvd.cond.<net>`` inside it), ``dvd.sample`` and
``dvd.unwarp``.

``model.quantize="int8"`` serves the DiT with W8A8 blocks and decoder
(``ops/quant.py``, ``models/dit.py``): those layers keep f32 weights (the
int8 codes are quantized from them, as ``dvd_tpu`` quantizes from its f32
parameters) while the rest of the DiT is stored in the compute dtype.

The alternative denoisers (``train_mode`` ``stage_1``,
``stage_1_transformer``, ``stage_1_doctr``; ``models/registry.py``) take
the same entry points: their conditioning is the VGG16 pyramid's 64-ch
``c20_for_unet`` plane (they need ``train_VGG=False``) and, under
``use_init_flow``, GeoTr's init flow; no seg or line stream is computed.
Their model function has no recurrent features and no timestep remap:
the sampler's rescaled ``G.model_t`` time goes in as it is, and the DDIM
loop carries no recurrent state for them (``dvd_tpu`` samples them with
``time_variant=False``).  ``model.quantize`` reaches the DiT alone, as in
``dvd_tpu``.

Refused: ``sr`` and ``trg_feat`` (``NotImplementedError``, as
``dvd_tpu``: no entry point makes their conditioning), an alternative
denoiser with ``train_VGG=True`` (``ValueError``), and
``serve_cond_chunk`` (not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dvd_tpu_torch.config import DvDConfig
from dvd_tpu_torch.diffusion.sampler import ddim_sample_loop
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule
from dvd_tpu_torch.models.dit import DiT, conditioning_pyramid_features
from dvd_tpu_torch.models.geotr import GeoTrSegInf
from dvd_tpu_torch.models.layers import seeded_init_
from dvd_tpu_torch.models.registry import (check_driver_mode, create_model,
                                           is_dit_mode)
from dvd_tpu_torch.models.textline_unet import TextLineUNet
from dvd_tpu_torch.models.u2net import Seg, seg_pyramid_to_latent
from dvd_tpu_torch.models.vgg import VGG16Pyramid, c20_for_dit, c20_for_unet
from dvd_tpu_torch.ops.kernels.unwarp import native_grid, unwarp  # noqa: F401
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.utils import trace
from dvd_tpu_torch.utils.grids import UNWARP_SHRINK

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_config(cfg: DvDConfig) -> None:
    """Raise for a train_mode the entry points cannot condition and an
    alternative denoiser without the VGG conditioning, as ``dvd_tpu``
    does, and for the flags whose code paths are not ported yet."""
    m = cfg.model
    check_driver_mode(m.train_mode)
    if not is_dit_mode(m.train_mode) and m.train_VGG:
        raise ValueError(
            f"train_mode={m.train_mode!r} needs the external VGG "
            "conditioning features (the reference's "
            "extract_raw_features_single, eval_utils.py:148); set "
            "model.train_VGG=False")
    todo = []
    if m.quantize not in ("none", "int8"):
        todo.append(f"quantize={m.quantize!r}")
    if m.serve_cond_chunk:
        todo.append("serve_cond_chunk > 0")
    if m.compute_dtype not in DTYPES or m.param_dtype not in DTYPES:
        todo.append(f"compute_dtype={m.compute_dtype!r}, "
                    f"param_dtype={m.param_dtype!r}")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _place_dit(dit: torch.nn.Module, device: torch.device,
               dtype: torch.dtype) -> None:
    """Move the denoiser to ``device`` and cast it to ``dtype``, all but a
    DiT's int8 layers' parameters, which stay f32 (``DiT.int8_layers``;
    the alternative denoisers have none)."""
    int8_layers = getattr(dit, "int8_layers", lambda: ())
    keep = {id(p) for _, layer in int8_layers() for p in layer.parameters()}
    dit.to(device)
    with torch.no_grad():
        for p in dit.parameters():
            if id(p) not in keep:
                p.data = p.data.to(dtype)
        for mod in dit.modules():
            for name, buf in mod.named_buffers(recurse=False):
                if buf.is_floating_point():
                    setattr(mod, name, buf.to(dtype))


@dataclasses.dataclass
class DewarpPipeline:
    """The networks + the schedule, on one device: the denoiser
    (``dit``: the DiT or an alternative family), Seg, the line UNet,
    GeoTrSegInf (with its GeoTr under ``use_init_flow``) and, under
    ``train_VGG=False``, the VGG16 pyramid.  The alternative families
    read only the VGG pyramid and, under ``use_init_flow``, GeoTrSegInf;
    Seg and the line UNet are built all the same, so that one set of
    weight files loads into any configuration."""

    cfg: DvDConfig
    dit: torch.nn.Module
    seg: Seg
    line: TextLineUNet
    geotr: GeoTrSegInf
    sched: DiffusionSchedule
    device: torch.device
    dtype: torch.dtype   # compute dtype of every network but the VGG's (f32)
    vgg: Optional[VGG16Pyramid] = None

    @classmethod
    def create(cls, cfg: DvDConfig, device="cuda",
               generator: Optional[torch.Generator] = None,
               dit: Optional[torch.nn.Module] = None,
               train: bool = False) -> "DewarpPipeline":
        """Build the networks for ``cfg`` on ``device`` (the card unless
        the caller asks for the CPU); with a (CPU) ``generator`` their
        weights are drawn from it (``seeded_init_``), else they keep
        torch's default init until weights are loaded.  ``dit`` replaces
        the config's denoiser (``models/registry.py:create_model``; tests
        use a narrow one; a DiT under int8 must be built with
        ``quant=True``).  With ``train`` the denoiser
        keeps ``model.param_dtype`` parameters that require gradients (the
        training step computes in ``compute_dtype`` under autocast), and
        drawn weights start its zero-initialised layers (the DiT's adaLN
        and final layers, the UNet's ``ZERO_INIT_LAYERS``) at zero, as the
        reference's training init; the aux nets stay frozen either way.
        GeoTr's transformer is built only under ``use_init_flow`` and the
        VGG pyramid only under ``train_VGG=False``; their weights are drawn
        after the other networks', whose drawn weights do not depend on
        these two flags."""
        check_config(cfg)
        m = cfg.model
        quant = m.quantize == "int8"
        device = torch.device(device)
        if dit is None:
            dit = create_model(cfg)
        if isinstance(dit, DiT) and dit.quant != quant:
            raise ValueError(f"model.quantize={m.quantize!r} with a DiT "
                             f"built with quant={dit.quant}")
        nets = dict(dit=dit, seg=Seg(m.source_size), line=TextLineUNet(),
                    geotr=GeoTrSegInf(m.source_size, m.use_init_flow,
                                      m.perception_size))
        if not m.train_VGG:
            nets["vgg"] = VGG16Pyramid()
        if generator is not None:
            for name, net in nets.items():
                seeded_init_(net, generator, zero_init=train and name == "dit")
        sched = make_schedule(steps=cfg.diffusion.diffusion_steps,
                              schedule_name=cfg.diffusion.noise_schedule,
                              respacing=cfg.diffusion.timestep_respacing,
                              rescale_timesteps=cfg.diffusion.rescale_timesteps,
                              device=device)
        # frozen (eval, no grad).  For serving the DiT is stored in the
        # compute dtype, but for its int8 layers' f32 weights; the conv
        # aux nets keep f32 weights and cast them, with BN folded, once per
        # weight set (fold_conv_bn); GeoTr's transformer is stored in the
        # compute dtype, as it computes
        dtype = DTYPES[m.compute_dtype]
        _place_dit(nets["dit"], device,
                   DTYPES[m.param_dtype] if train else dtype)
        for net in nets.values():
            net.to(device).eval().requires_grad_(False)
        if nets["geotr"].GeoTr is not None:
            nets["geotr"].GeoTr.to(dtype)
        if train:
            nets["dit"].requires_grad_(True)
        return cls(cfg=cfg, sched=sched, device=device, dtype=dtype, **nets)

    @property
    def is_dit(self) -> bool:
        return isinstance(self.dit, DiT)

    # ------------------------------------------------------ conditioning
    def build_conditioning(self, source512: torch.Tensor):
        """(B, 512, 512, 3) in [0, 1] -> (cond, init_flow, init_feat): the
        conditioning dict (NCHW tensors) and the zero recurrent state.  An
        alternative denoiser's dict holds only ``src_feat``, the VGG16
        pyramid's 64-ch ``c20_for_unet`` plane (reference
        ``extract_raw_features_single``, eval_utils.py:148), and GeoTr
        runs only when its init flow is used."""
        with trace.span("dvd.cond", pages=source512.shape[0]):
            m = self.cfg.model
            s, per = m.image_size, m.perception_size
            x = source512.to(self.device, torch.float32).permute(0, 3, 1, 2)
            x = x.contiguous()
            b = x.shape[0]
            init_feat = torch.zeros((b, 256, s, s), device=self.device)
            if not self.is_dit and not m.use_init_flow:
                with trace.span("dvd.cond.vgg"):
                    feat = c20_for_unet(self.vgg(x), s)
                return ({"src_feat": feat}, self._init_flow(None, b),
                        init_feat)
            xa = resize_bilinear(x, (per, per), True).to(self.dtype)
            xa = xa.contiguous()
            with trace.span("dvd.cond.geotr"):
                ref_bm, mask_cat = self.geotr(xa)
            if not self.is_dit:
                with trace.span("dvd.cond.vgg"):
                    feat = c20_for_unet(self.vgg(x), s)
                return ({"src_feat": feat}, self._init_flow(ref_bm, b),
                        init_feat)
            cond = {"y512": x, "mask_cat": mask_cat}
            if not m.use_gt_mask:
                with trace.span("dvd.cond.seg"):
                    mskx, _, pyramid = self.seg(xa)
                    cond["mask_y512"] = seg_pyramid_to_latent(pyramid, s)
                if m.use_line_mask:
                    with trace.span("dvd.cond.line"):
                        line_feat, _ = self.line(mskx)
                        cond["line_msk"] = resize_bilinear(line_feat, (s, s),
                                                           False)
            if self.vgg is not None:
                # the frozen VGG16 features in f32 replace the DiT's pyramid
                # (reference evaluation.py:224-236)
                with trace.span("dvd.cond.vgg"):
                    cond["src_feat"] = c20_for_dit(self.vgg(x), s)
            return cond, self._init_flow(ref_bm, b), init_feat

    def _init_flow(self, ref_bm: Optional[torch.Tensor], b: int
                   ) -> torch.Tensor:
        """GeoTr's coarse offsets as the (B, S, S, 2) init_flow (reference
        evaluation.py:176-179: ref_bm / 287, bilinear to the latent), or
        zeros without GeoTr."""
        m = self.cfg.model
        s = m.image_size
        if ref_bm is None:
            return torch.zeros((b, s, s, 2), device=self.device)
        ref_flow = (ref_bm.float() / (m.perception_size - 1.0)) \
            .permute(0, 3, 1, 2)
        return resize_bilinear(ref_flow, (s, s), True) \
            .permute(0, 2, 3, 1).contiguous()

    # ---------------------------------------------------------- sampling
    def _hoist_pyramid(self, cond: Dict) -> Dict:
        """Run the DiT's conditioning pyramid once, outside the DDIM loop,
        and feed it through the ``src_feat`` bypass (its input is constant
        across steps and hypotheses); the VGG features are already there
        under ``train_VGG=False``.  y512/mask_cat are then unused."""
        out = dict(cond)
        y512, mask_cat = out.pop("y512"), out.pop("mask_cat", None)
        if "src_feat" not in out:
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
        if not self.is_dit:
            # the reference's UNet-era call: no recurrent features, no
            # timestep remap (t is the sampler's rescaled G.model_t)
            return self.dit(x, t, src_feat=cond["src_feat"],
                            init_flow=init_flow), init_feat
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
        (a generator on the pipeline's device).  The alternative denoisers
        are sampled without the recurrent state, as ``dvd_tpu`` samples
        them (``time_variant=False``: no re-warp, init_flow held)."""
        with trace.span("dvd.sample", pages=init_flow.shape[0]):
            tv = self.is_dit and bool(self.cfg.model.time_variant)
            if self.is_dit:
                cond = self._hoist_stream_tokens(self._hoist_pyramid(cond))
            d = self.cfg.diffusion
            return ddim_sample_loop(
                self.model_fn, self.sched, cond, init_flow,
                init_feat if tv else None,
                latent_size=self.cfg.model.image_size, n_batch=d.n_batch,
                time_variant=tv, eta=d.eta, clip_denoised=d.clip_denoised,
                generator=generator, init_noise=init_noise).flow

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
