"""Variational-bound (likelihood) utilities (port of
``dvd_tpu/diffusion/likelihood.py``; reference
``improved_diffusion/losses.py:11-76`` and ``gaussian_diffusion.py``
``_vb_terms_bpd`` ``:798-831``, ``_prior_bpd`` ``:1105-1119``,
``calc_bpd_loop`` ``:1121-1178``).

The production configuration (x0 prediction, FIXED_LARGE variance) in
bits per dimension.  Images are NCHW; every function is batched over the
leading axis and reduces over the rest.  ``calc_bpd_loop`` is a Python
loop over t from T-1 down to 0 (the model call at each step goes through
the kernels on a card).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from dvd_tpu_torch.diffusion import gaussian as G
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule

LN2 = 0.6931471805599453


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), elementwise in
    nats; any argument may be a Python number."""
    args = (mean1, logvar1, mean2, logvar2)
    ref = next((x for x in args if torch.is_tensor(x)), torch.zeros(()))
    mean1, logvar1, mean2, logvar2 = (
        x if torch.is_tensor(x) else
        torch.as_tensor(x, dtype=ref.dtype, device=ref.device) for x in args)
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Tanh approximation of Phi(x), as the reference's."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *,
                                        means: torch.Tensor,
                                        log_scales: torch.Tensor
                                        ) -> torch.Tensor:
    """log p(x) of a Gaussian discretised to the 256 buckets of [-1, 1]
    (width 1/127.5); ``x`` already scaled to [-1, 1]."""
    centered = x - means
    inv_std = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_std * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_std * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_delta))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the first (reference ``nn.py:103-107``)."""
    return x.mean(dim=tuple(range(1, x.dim())))


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def p_mean_variance_from_xstart(sched: DiffusionSchedule, x_t: torch.Tensor,
                                t: torch.Tensor, pred_xstart: torch.Tensor,
                                *, clip_denoised: bool = True
                                ) -> PMeanVariance:
    """Moments of p(x_{t-1} | x_t) for x0 prediction with FIXED_LARGE
    variance (reference ``p_mean_variance``, ``:294-415``)."""
    if clip_denoised:
        pred_xstart = pred_xstart.clamp(-1.0, 1.0)
    mean = G.q_posterior_mean(sched, pred_xstart, x_t, t)
    log_variance = sched.gather(sched.fixed_large_log_variance, t,
                                x_t.dim()).expand(x_t.shape)
    return PMeanVariance(mean, log_variance, pred_xstart)


def vb_terms_bpd(sched: DiffusionSchedule, x_start: torch.Tensor,
                 x_t: torch.Tensor, t: torch.Tensor,
                 pred_xstart: torch.Tensor, *, clip_denoised: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """One bound term L_{t-1} (the decoder NLL where t == 0) in bits per
    dimension, (B,)."""
    true_mean = G.q_posterior_mean(sched, x_start, x_t, t)
    true_logvar = sched.gather(sched.posterior_log_variance_clipped, t,
                               x_t.dim())
    out = p_mean_variance_from_xstart(sched, x_t, t, pred_xstart,
                                      clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_logvar, out.mean,
                             out.log_variance)) / LN2
    decoder_nll = -mean_flat(discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)) / LN2
    return {"output": torch.where(t == 0, decoder_nll, kl),
            "pred_xstart": out.pred_xstart}


def prior_bpd(sched: DiffusionSchedule, x_start: torch.Tensor
              ) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits per dimension, (B,)."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1,
                   dtype=torch.long, device=x_start.device)
    nd = x_start.dim()
    qt_mean = sched.gather(sched.sqrt_alphas_cumprod, t, nd) * x_start
    qt_logvar = torch.log(1.0 - sched.gather(sched.alphas_cumprod, t, nd))
    return mean_flat(normal_kl(qt_mean, qt_logvar, 0.0, 0.0)) / LN2


def calc_bpd_loop(denoise_xstart_fn: Callable[[torch.Tensor, torch.Tensor],
                                              torch.Tensor],
                  sched: DiffusionSchedule, x_start: torch.Tensor,
                  generator: Optional[torch.Generator], *,
                  clip_denoised: bool = True,
                  noise: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """The whole bound, t from T-1 down to 0 (reference
    ``calc_bpd_loop``).

    ``denoise_xstart_fn(x_t, t) -> pred_xstart`` wraps the model call.
    Each step's noise is drawn from ``generator`` on x_start's device, or
    taken from ``noise`` (T, *x_start.shape), whose row t is timestep t's
    draw (a pin).  Returns ``total_bpd`` and ``prior_bpd`` (B,) and the
    per-timestep ``vb``, ``xstart_mse`` and ``mse`` (the eps MSE) as
    (T, B), in ascending t as the reference's lists."""
    b = x_start.shape[0]
    T = sched.num_timesteps
    vb, xstart_mse, eps_mse = [], [], []
    for ti in range(T - 1, -1, -1):
        t = torch.full((b,), ti, dtype=torch.long, device=x_start.device)
        eps = noise[ti].to(x_start) if noise is not None else torch.randn(
            x_start.shape, generator=generator, device=x_start.device,
            dtype=x_start.dtype)
        x_t = G.q_sample(sched, x_start, t, eps)
        terms = vb_terms_bpd(sched, x_start, x_t, t,
                             denoise_xstart_fn(x_t, t),
                             clip_denoised=clip_denoised)
        pred = terms["pred_xstart"]
        vb.append(terms["output"])
        xstart_mse.append(mean_flat((pred - x_start) ** 2))
        eps_pred = G.predict_eps_from_xstart(sched, x_t, t, pred)
        eps_mse.append(mean_flat((eps_pred - eps) ** 2))
    vb, xstart_mse, eps_mse = (torch.stack(v[::-1]) for v in
                               (vb, xstart_mse, eps_mse))
    prior = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=0) + prior, "prior_bpd": prior,
            "vb": vb, "xstart_mse": xstart_mse, "mse": eps_mse}
