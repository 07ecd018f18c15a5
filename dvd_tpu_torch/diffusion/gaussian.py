"""DDIM step and the model-facing timestep map (port of the serving part
of ``dvd_tpu/diffusion/gaussian.py``: x0-parameterised prediction, the
eq. 12 DDIM update, reference ``gaussian_diffusion.py:445-492``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t: torch.Tensor,
                            t: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    nd = x_t.dim()
    return (sched.gather(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0) \
        / sched.gather(sched.sqrt_recipm1_alphas_cumprod, t, nd)


class DDIMStep(NamedTuple):
    sample: torch.Tensor       # x_{t-1}
    pred_xstart: torch.Tensor


def ddim_step(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
              pred_xstart: torch.Tensor, *, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None,
              clip_denoised: bool = False) -> DDIMStep:
    """One DDIM update given the model's x0 prediction."""
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    nd = x_t.dim()
    eps = predict_eps_from_xstart(sched, x_t, t, pred_xstart)
    ab = sched.gather(sched.alphas_cumprod, t, nd)
    ab_prev = sched.gather(sched.alphas_cumprod_prev, t, nd)
    sigma = eta * torch.sqrt((1.0 - ab_prev) / (1.0 - ab)) \
        * torch.sqrt(1.0 - ab / ab_prev)
    mean_pred = pred_xstart * torch.sqrt(ab_prev) \
        + torch.sqrt(torch.clamp(1.0 - ab_prev - sigma ** 2, min=0.0)) * eps
    if eta == 0.0:
        return DDIMStep(mean_pred, pred_xstart)
    if noise is None:
        raise ValueError("ddim_step with eta > 0 requires noise")
    nonzero = (t != 0).to(x_t.dtype).reshape((-1,) + (1,) * (nd - 1))
    return DDIMStep(mean_pred + nonzero * sigma * noise, pred_xstart)


def model_t(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """Compact timestep index -> model-facing (rescaled) timestep value."""
    return sched.model_timesteps[t]
