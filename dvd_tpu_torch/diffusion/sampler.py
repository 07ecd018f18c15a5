"""DDIM sampling loop for the DvD coordinate diffusion (port of
``dvd_tpu/diffusion/sampler.py:ddim_sample_loop``).

- the ``n_batch`` hypotheses ride the batch, hypothesis-major
  (``x.repeat(n, ...)``, the reference's ``repeat(n_batch, 1, 1, 1)``);
- the time-variant recurrent state (init_flow <- pred_flow, init_feat <-
  the re-warped features, reference ``gaussian_diffusion.py:618-624``) is
  carried between steps; the re-warp is skipped on the first step with a
  plain ``if``;
- the result is the hypothesis mean, then a clamp to [-1, 1].

Flows are (N, S, S, 2) channel-last; features are NCHW.  The feature
re-warp goes through ``ops.grid_sample.warp`` and so through K3 on a card.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dvd_tpu_torch.diffusion import gaussian as G
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule
from dvd_tpu_torch.ops.grid_sample import warp
from dvd_tpu_torch.utils.grids import flow_to_grid

# model_fn(x, t, cond, *, init_flow, init_feat, seed_init_feat,
#          remap_timesteps) -> (pred_x0_flow, cond_feat)
ModelFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


class SampleResult(NamedTuple):
    flow: torch.Tensor         # (B, S, S, 2) clamped hypothesis mean
    hypotheses: torch.Tensor   # (n_batch, B, S, S, 2) per-hypothesis x0


def _repeat(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.repeat((n,) + (1,) * (t.dim() - 1))


def ddim_sample_loop(
    model_fn: ModelFn,
    sched: DiffusionSchedule,
    cond: Dict[str, torch.Tensor],
    init_flow: torch.Tensor,
    init_feat: Optional[torch.Tensor],
    *,
    latent_size: int,
    n_batch: int = 2,
    time_variant: bool = True,
    eta: float = 0.0,
    clip_denoised: bool = False,
    generator: Optional[torch.Generator] = None,
    init_noise: Optional[torch.Tensor] = None,
) -> SampleResult:
    """Full T-step DDIM inference.

    ``init_noise``: optional (n_batch*B, S, S, 2) x_T, hypothesis-major;
    otherwise x_T (and the per-step noise when eta > 0) is drawn from
    ``generator`` on the flow's device."""
    b = init_flow.shape[0]
    s = latent_size
    dev = init_flow.device
    nb = n_batch * b
    cond_r = {k: _repeat(v, n_batch) for k, v in cond.items() if v is not None}
    fl = _repeat(init_flow, n_batch)
    ft = _repeat(init_feat, n_batch) if init_feat is not None else \
        torch.zeros((nb, 256, s, s), dtype=torch.float32, device=dev)
    if init_noise is not None:
        x = init_noise.to(dev, torch.float32)
    else:
        x = torch.randn((nb, s, s, 2), generator=generator, device=dev)

    T = sched.num_timesteps
    pred_flow, feat = fl, ft
    for i in range(T - 1, -1, -1):
        first = i == T - 1
        if time_variant and not first:
            fl = pred_flow
            ft = warp(feat, flow_to_grid(pred_flow))
        t = torch.full((nb,), i, dtype=torch.long, device=dev)
        pred_x0, feat = model_fn(x, G.model_t(sched, t), cond_r,
                                 init_flow=fl, init_feat=ft,
                                 seed_init_feat=first, remap_timesteps=True)
        noise = None
        if eta != 0.0:
            noise = torch.randn(x.shape, generator=generator, device=dev)
        step = G.ddim_step(sched, x, t, pred_x0, eta=eta, noise=noise,
                           clip_denoised=clip_denoised)
        x, pred_flow = step.sample, step.pred_xstart

    hyp = pred_flow.reshape(n_batch, b, s, s, 2)
    return SampleResult(flow=hyp.mean(dim=0).clamp(-1.0, 1.0), hypotheses=hyp)
