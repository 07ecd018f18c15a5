"""Model + diffusion factory (port of ``dvd_tpu/models/registry.py``;
reference ``improved_diffusion/script_util.py:38-244``).

``train_mode`` selects the denoiser as the reference's ``create_model``
switch (``script_util.py:93-203``):

- ``stage_1_dit_cross`` / ``stage_1_dit_cat``: the DiT (production);
- ``stage_1``: the UNet denoiser, 68-ch input (src_feat 64 + x 2 +
  init_flow 2);
- ``sr``: the UNet super-resolution variant, 85-ch input;
- ``trg_feat``: the UNet with correlation + target-feature input (149 ch);
- ``stage_1_transformer``: the pure-transformer denoiser;
- ``stage_1_doctr``: GeoTr2 (DocTr as a denoiser).

``sr`` and ``trg_feat`` can be built and called, but no entry point
produces their conditioning (a low-resolution target, a correlation
volume and target features); serving and training refuse them, as
``dvd_tpu``'s and the reference's ``run_training.py`` do.  ``model.quantize`` reaches
the DiT alone (``dvd_tpu`` passes ``quant`` only to ``make_dit``).
"""

from __future__ import annotations

from typing import Tuple

import torch.nn as nn

from dvd_tpu_torch.config import DvDConfig
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule
from dvd_tpu_torch.models.dit import make_dit
from dvd_tpu_torch.models.geotr import GeoTr2
from dvd_tpu_torch.models.transformer_denoiser import TransformerDenoiser
from dvd_tpu_torch.models.unet_denoiser import UNetDenoiser

DIT_MODES = ("stage_1_dit_cross", "stage_1_dit_cat")

# the DiT families and the alternative families that take (x, t,
# src_feat 64 ch, init_flow): the modes that serving and training can
# condition
DRIVER_MODES = DIT_MODES + (
    "stage_1", "stage_1_transformer", "stage_1_doctr")


def check_driver_mode(mode: str) -> None:
    """Refuse a train_mode that serving and training cannot condition
    (loudly)."""
    if mode not in DRIVER_MODES:
        raise NotImplementedError(
            f"train_mode={mode!r} is constructible via create_model but not "
            f"drivable end to end: the conditioning path produces only the "
            f"(x, t, src_feat, init_flow) convention. Drivable modes: "
            f"{DRIVER_MODES}")


def is_dit_mode(mode: str) -> bool:
    """True for the production DiT modes; False for the alternative
    families (UNet, pure transformer, GeoTr2), which take the reference's
    UNet-era call (x, t, src_feat, init_flow) and train through the plain
    masked MSE (reference train_util.py:350-366)."""
    return mode in DIT_MODES


def attention_ds(image_size: int, attention_resolutions: str
                 ) -> Tuple[int, ...]:
    """'16,8' -> the downsampling ratios (script_util.py:164-168)."""
    return tuple(image_size // int(r)
                 for r in attention_resolutions.split(","))


def unet_channel_mult(image_size: int) -> Tuple[int, ...]:
    """The reference UNet's width ladder by latent size
    (script_util.py:109-117)."""
    if image_size == 256:
        return (1, 1, 2, 2, 4, 4)
    if image_size == 64:
        return (1, 2, 3, 4)
    if image_size == 32:
        return (1, 2, 2, 2)
    if image_size < 32:
        # beyond the reference's ladder (it raises here): down-scaled test
        # configs reuse the 32 px ladder, which still leaves a >= 2 px bottom
        return (1, 2, 2, 2)
    raise ValueError(f"unsupported image size for UNet modes: {image_size}")


# the UNet modes' input widths (script_util.py:168-203)
UNET_IN_CHANNELS = {"stage_1": 68, "sr": 85, "trg_feat": 149}


def create_model(cfg: DvDConfig) -> nn.Module:
    """The denoiser of ``cfg.model.train_mode`` (f32 parameters on the CPU;
    the pipeline places and casts it)."""
    m = cfg.model
    mode = m.train_mode
    if mode in DIT_MODES:
        return make_dit(m.dit_variant, input_size=m.image_size,
                        in_channels=m.in_channels, tv=m.time_variant,
                        chain_blocks=m.chain_blocks,
                        with_mask=not m.use_gt_mask,
                        with_line=m.use_line_mask and not m.use_gt_mask,
                        quant=m.quantize == "int8",
                        separate_cross_attn=m.separate_cross_attn)
    if mode in UNET_IN_CHANNELS:
        return UNetDenoiser(
            in_channels=UNET_IN_CHANNELS[mode], model_channels=m.num_channels,
            out_channels=m.in_channels, num_res_blocks=m.num_res_blocks,
            attention_ds=attention_ds(m.image_size, m.attention_resolutions),
            channel_mult=unet_channel_mult(m.image_size),
            num_heads=m.num_heads,
            # only stage_1 reads num_heads_upsample (script_util.py:93-203)
            num_heads_upsample=m.num_heads_upsample if mode == "stage_1"
            else -1,
            use_scale_shift_norm=m.use_scale_shift_norm, train_mode=mode)
    if mode == "stage_1_transformer":
        # ff_dim 1024 and 6 layers fixed by the factory
        # (script_util.py:139-148)
        return TransformerDenoiser(model_channels=m.num_channels,
                                   out_channels=m.in_channels,
                                   num_heads=m.num_heads, num_layers=6,
                                   ff_dim=1024)
    if mode == "stage_1_doctr":
        return GeoTr2(latent=m.image_size)
    raise ValueError(f"unknown train_mode {mode!r}")


def create_model_and_diffusion(cfg: DvDConfig, device="cuda"
                               ) -> Tuple[nn.Module, DiffusionSchedule]:
    d = cfg.diffusion
    sched = make_schedule(steps=d.diffusion_steps,
                          schedule_name=d.noise_schedule,
                          respacing=d.timestep_respacing,
                          rescale_timesteps=d.rescale_timesteps,
                          device=device)
    return create_model(cfg), sched
