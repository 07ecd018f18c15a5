"""Timestep samplers (port of ``dvd_tpu/training/resample.py``; reference
``resample.py:8-154``).

- uniform: equal probability over the compact timesteps (production);
- loss-second-moment: importance sampling from a running per-timestep
  sqrt-second-moment of the loss, uniform until every timestep has
  ``history_per_term`` observations.

Draws come from an explicit ``torch.Generator`` on the device the tensors
live on; the sampler state is a pair of small tensors on that device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def uniform_sample(generator: Optional[torch.Generator], batch: int,
                   num_timesteps: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                      device=device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)


@dataclasses.dataclass
class LossSecondMomentState:
    history: torch.Tensor        # (T, history_per_term) f32
    counts: torch.Tensor         # (T,) int64

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10,
               device=None) -> "LossSecondMomentState":
        return cls(
            history=torch.zeros((num_timesteps, history_per_term),
                                dtype=torch.float32, device=device),
            counts=torch.zeros((num_timesteps,), dtype=torch.long,
                               device=device))


def loss_aware_weights(state: LossSecondMomentState,
                       uniform_prob: float = 0.001) -> torch.Tensor:
    """Per-timestep sampling probabilities."""
    T, H = state.history.shape
    warmed = (state.counts >= H).all()
    w = torch.sqrt((state.history ** 2).mean(-1))
    w = w / w.sum().clamp(min=1e-12)
    w = w * (1 - uniform_prob) + uniform_prob / T
    return torch.where(warmed, w, torch.full_like(w, 1.0 / T))


def loss_aware_sample(generator: Optional[torch.Generator], batch: int,
                      state: LossSecondMomentState
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    p = loss_aware_weights(state)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


@torch.no_grad()
def update_history(state: LossSecondMomentState, t: torch.Tensor,
                   losses: torch.Tensor) -> LossSecondMomentState:
    """Append per-sample losses into each timestep's FIFO ring, one sample
    after the other (the JAX package's scan)."""
    hist, counts = state.history.clone(), state.counts.clone()
    h = hist.shape[1]
    t = t.long()
    losses = losses.float()
    for i in range(t.shape[0]):
        ti = t[i]
        hist[ti, counts[ti] % h] = losses[i]
        counts[ti] += 1
    return LossSecondMomentState(history=hist, counts=counts)
