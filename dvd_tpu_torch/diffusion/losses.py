"""Training losses for the coordinate-denoising diffusion (port of
``dvd_tpu/diffusion/losses.py``).

- :func:`time_variant_loss` -- the production path (``iter=True``,
  reference ``training_losses_time_variant``, gaussian_diffusion.py:
  890-1006): the vectorised partial DDIM rollout synthesises the
  recurrent ``init_flow``/``init_feat``, then one supervised model call
  with the warp-composed masked MSE;
- :func:`composed_warp_loss` -- the no-rollout DiT path (``iter=False``,
  ``training_losses_new_dit``, ``:1009-1059``);
- :func:`plain_masked_mse` -- the alternative denoisers' (``training_losses``,
  ``:1062-1102``): no warp, no rollout.

The loss is ``sum((target - f_new)^2) / sum(mask)`` over the
512^2-upsampled field, where ``f_new = warp(f_inter, (out + base) * 2 -
1)`` composes the ground-truth intermediate map with the prediction
(``ops.grid_sample.warp_const_src``: K3 forward, K4 backward on a card).

Noise: each loss takes an optional explicit ``noise`` (and, for the
rollout, ``rollout_noise``) tensor, else draws from ``generator`` on the
flow's device (for the global batch under ``parallel.comm.batch_rows``).
Layout: flows and masks channel-last, as ``dvd_tpu``;
conditioning tensors NCHW, as the port's DiT takes them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from dvd_tpu_torch.diffusion import gaussian as G
from dvd_tpu_torch.diffusion.sampler import (ModelFn,
                                             rollout_states_for_training)
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule
from dvd_tpu_torch.ops.grid_sample import warp_const_src
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.parallel import comm
from dvd_tpu_torch.utils import trace
from dvd_tpu_torch.utils.dtypes import at_least_f32
from dvd_tpu_torch.utils.grids import base_grid


def _resize_hwc(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, S, S, C) -> (B, size, size, C), bilinear, align_corners=True."""
    out = resize_bilinear(x.permute(0, 3, 1, 2), (size, size), True)
    return out.permute(0, 2, 3, 1)


def _to_pm(offsets: torch.Tensor) -> torch.Tensor:
    """Offset field (B, H, W, 2) -> the [-1, 1] backward map."""
    h, w = offsets.shape[1:3]
    return (offsets + base_grid(h, w, offsets.dtype, offsets.device)) \
        * 2.0 - 1.0


def _composed_terms(x_start_pm: torch.Tensor, model_output: torch.Tensor,
                    f_inter_pm: torch.Tensor, mask: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    h = mask.shape[1]
    target = _resize_hwc(x_start_pm, h) * mask
    out512 = _resize_hwc(at_least_f32(model_output), h) * mask
    f_pred = _to_pm(out512)
    f_new = warp_const_src(f_inter_pm.permute(0, 3, 1, 2), f_pred)
    num = ((target - f_new.permute(0, 2, 3, 1)) ** 2).sum((1, 2, 3))
    den_per = mask.sum((1, 2, 3))
    return _masked_terms(num, den_per)


def _masked_terms(num: torch.Tensor, den_per: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The loss sum(num) / sum(den) and its parts: ``num`` and ``den`` (the
    mask's sum, no gradient) let a data-parallel step normalise by the
    global batch's mask."""
    mse = num.sum() / den_per.sum()
    return {"mse": mse, "loss": mse, "num": num.sum(),
            "den": den_per.sum().detach(),
            "mse_per": num / den_per.clamp(min=1e-12)}


def _prepare(x_start, x_start_inter, mask):
    if mask.dim() == 3:
        mask = mask[..., None]
    return _to_pm(x_start), _to_pm(x_start_inter), mask


def _noise(like: torch.Tensor, noise: Optional[torch.Tensor],
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is not None:
        return noise.to(like.device, like.dtype)
    return comm.randn(like.shape, generator=generator, device=like.device)


def composed_warp_loss(
    model_fn: ModelFn,
    sched: DiffusionSchedule,
    cond: Dict[str, torch.Tensor],
    init_flow: torch.Tensor,
    init_feat: Optional[torch.Tensor],
    x_start: torch.Tensor,          # (B, S, S, 2) GT offsets at latent res
    x_start_inter: torch.Tensor,    # (B, H, H, 2) intermediate offsets
    mask: torch.Tensor,             # (B, H, H) or (B, H, H, 1)
    t: torch.Tensor,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """training_losses_new_dit (iter=False): no t == T-1 feature seeding
    (the reference seeds only when iter=True, cross_model.py:596-601)."""
    x_start_pm, f_inter_pm, mask = _prepare(x_start, x_start_inter, mask)
    x_t = G.q_sample(sched, x_start_pm, t,
                     _noise(x_start_pm, noise, generator))
    model_output, _ = model_fn(
        x_t, t.float(), cond, init_flow=init_flow, init_feat=init_feat,
        seed_init_feat=None, remap_timesteps=False)
    return _composed_terms(x_start_pm, model_output, f_inter_pm, mask)


def time_variant_loss(
    model_fn: ModelFn,
    sched: DiffusionSchedule,
    cond: Dict[str, torch.Tensor],
    init_flow: torch.Tensor,
    init_feat: torch.Tensor,
    x_start: torch.Tensor,
    x_start_inter: torch.Tensor,
    mask: torch.Tensor,
    t: torch.Tensor,
    *,
    rollout_remap: bool = False,
    noise: Optional[torch.Tensor] = None,
    rollout_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """training_losses_time_variant (iter=True, production).

    The rollout runs without gradient (the reference's runs under
    ``torch.no_grad``); the supervised call then gets the raw compact
    timesteps (no rescale, no remap: reference ``:978``) and seeds the
    recurrent features where ``t == T - 1``.  The rollout is the span
    ``dvd.train.rollout`` (``utils/trace.py``)."""
    x_start_pm, f_inter_pm, mask = _prepare(x_start, x_start_inter, mask)
    x_t = G.q_sample(sched, x_start_pm, t,
                     _noise(x_start_pm, noise, generator))
    s = x_start.shape[1]
    with trace.span("dvd.train.rollout"):
        init_flow_r, init_feat_r = rollout_states_for_training(
            model_fn, sched, cond, init_flow, init_feat, t, latent_size=s,
            remap_timesteps=rollout_remap, noise=rollout_noise,
            generator=generator)
    model_output, _ = model_fn(
        x_t, t.float(), cond, init_flow=init_flow_r, init_feat=init_feat_r,
        seed_init_feat=(t == sched.num_timesteps - 1),
        remap_timesteps=False)
    return _composed_terms(x_start_pm, model_output, f_inter_pm, mask)


def plain_masked_mse(
    model_fn: Callable,
    sched: DiffusionSchedule,
    cond: Dict[str, torch.Tensor],
    x_start: torch.Tensor,          # (B, S, S, 2) GT offsets at latent res
    mask: torch.Tensor,             # (B, H, H) or (B, H, H, 1)
    t: torch.Tensor,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    **model_kwargs,
) -> Dict[str, torch.Tensor]:
    """training_losses (the plain masked MSE at the mask's size, reference
    ``:1062-1102``) for the alternative denoisers: ``model_fn(x_t,
    model_t(t), cond, **model_kwargs)`` sees the rescaled timesteps (the
    reference routes this loss through SpacedDiffusion's wrapper), and its
    output and x_start, both bilinear (align_corners) at H, are compared
    under the mask."""
    if mask.dim() == 3:
        mask = mask[..., None]
    h = mask.shape[1]
    x_t = G.q_sample(sched, x_start, t, _noise(x_start, noise, generator))
    out = model_fn(x_t, G.model_t(sched, t), cond, **model_kwargs)
    target = _resize_hwc(x_start, h) * mask
    out = _resize_hwc(at_least_f32(out), h) * mask
    num = ((target - out) ** 2).sum((1, 2, 3))
    return _masked_terms(num, mask.sum((1, 2, 3)))
