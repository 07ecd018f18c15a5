"""DDIM sampling loop for the DvD coordinate diffusion (port of
``dvd_tpu/diffusion/sampler.py:ddim_sample_loop``).

- the ``n_batch`` hypotheses ride the batch, hypothesis-major
  (``x.repeat(n, ...)``, the reference's ``repeat(n_batch, 1, 1, 1)``);
- the time-variant recurrent state (init_flow <- pred_flow, init_feat <-
  the re-warped features, reference ``gaussian_diffusion.py:618-624``) is
  carried between steps; the re-warp is skipped on the first step with a
  plain ``if``;
- the result is the hypothesis mean, then a clamp to [-1, 1];
- each step is a ``dvd.sample.step`` span (``utils/trace.py``).

Flows are (N, S, S, 2) channel-last; features are NCHW.  The feature
re-warp goes through ``ops.grid_sample.warp`` and so through K3 on a card.

Also the training rollout (``rollout_states_for_training``): the
reference's per-sample partial DDIM rollout in vectorised form.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dvd_tpu_torch.diffusion import gaussian as G
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule
from dvd_tpu_torch.ops.grid_sample import warp
from dvd_tpu_torch.parallel import comm
from dvd_tpu_torch.utils import trace
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
    ``generator`` on the flow's device (for the global batch under
    ``parallel.comm.batch_rows``)."""
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
        x = comm.randn((nb, s, s, 2), generator=generator, device=dev)

    T = sched.num_timesteps
    pred_flow, feat = fl, ft
    for i in range(T - 1, -1, -1):
        with trace.span("dvd.sample.step", step=i):
            first = i == T - 1
            if time_variant and not first:
                fl = pred_flow
                ft = warp(feat, flow_to_grid(pred_flow))
            t = torch.full((nb,), i, dtype=torch.long, device=dev)
            pred_x0, feat = model_fn(
                x, G.model_t(sched, t), cond_r, init_flow=fl, init_feat=ft,
                seed_init_feat=torch.full((nb,), first, device=dev),
                remap_timesteps=True)
            noise = None
            if eta != 0.0:
                noise = comm.randn(x.shape, generator=generator, device=dev)
            step = G.ddim_step(sched, x, t, pred_x0, eta=eta, noise=noise,
                               clip_denoised=clip_denoised)
            x, pred_flow = step.sample, step.pred_xstart

    hyp = pred_flow.reshape(n_batch, b, s, s, 2)
    return SampleResult(flow=hyp.mean(dim=0).clamp(-1.0, 1.0), hypotheses=hyp)


@torch.no_grad()
def rollout_states_for_training(
    model_fn: ModelFn,
    sched: DiffusionSchedule,
    cond: Dict[str, torch.Tensor],
    init_flow: torch.Tensor,
    init_feat: torch.Tensor,
    t: torch.Tensor,
    *,
    latent_size: int,
    remap_timesteps: bool = False,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrent (init_flow, init_feat) each sample's timestep would
    see (reference ``training_losses_time_variant``,
    gaussian_diffusion.py:921-972), without gradient.

    The whole batch is rolled from T-1 down to 1 once, and after step i
    the samples with ``t == i - 1`` take the handed-off state: the flow
    clamped to [-1, 1] and the features re-warped with it.  Samples with
    ``t == T - 1`` keep the initial state.  The carry inside the rollout
    stays unclamped.  The model sees rescaled t with no remap unless
    ``remap_timesteps``.  ``noise`` pins x_T (B, S, S, 2); otherwise it is
    drawn from ``generator``."""
    b = init_flow.shape[0]
    s = latent_size
    dev = init_flow.device
    x = noise.to(dev, torch.float32) if noise is not None else \
        comm.randn((b, s, s, 2), generator=generator, device=dev)
    ti = t.long()
    out_flow, out_feat = init_flow, init_feat
    cur_flow, cur_feat = init_flow, init_feat
    pred_flow, feat = init_flow, init_feat
    T = sched.num_timesteps
    for i in range(T - 1, 0, -1):     # steps T-1 .. 1 (state for t = i-1)
        first = i == T - 1
        if not first:
            cur_flow = pred_flow
            feat = warp(feat, flow_to_grid(pred_flow))
            cur_feat = feat
        t_vec = torch.full((b,), i, dtype=torch.long, device=dev)
        pred_x0, feat = model_fn(
            x, G.model_t(sched, t_vec), cond, init_flow=cur_flow,
            init_feat=cur_feat,
            seed_init_feat=torch.full((b,), first, device=dev),
            remap_timesteps=remap_timesteps)
        step = G.ddim_step(sched, x, t_vec, pred_x0, eta=0.0)
        x, pred_flow = step.sample, step.pred_xstart
        handoff = pred_flow.clamp(-1.0, 1.0)
        sel = (ti == i - 1)
        out_flow = torch.where(sel[:, None, None, None], handoff, out_flow)
        out_feat = torch.where(sel[:, None, None, None],
                               warp(feat, flow_to_grid(handoff)), out_feat)
    return out_flow, out_feat
