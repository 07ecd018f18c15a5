"""Diffusion noise schedules as a table of tensors (port of
``dvd_tpu/diffusion/schedule.py``).

Tables are computed in float64 numpy (the reference's precision choice),
respacing folded in, and stored as float32 tensors on one device; the
sampler indexes them with a timestep vector.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Set, Union

import numpy as np
import torch


def linear_betas(n: int) -> np.ndarray:
    scale = 1000.0 / n
    return np.linspace(scale * 1e-4, scale * 0.02, n, dtype=np.float64)


def cosine_betas(n: int, max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.array([min(1.0 - alpha_bar((i + 1) / n) / alpha_bar(i / n),
                         max_beta) for i in range(n)], dtype=np.float64)


def named_betas(name: str, n: int) -> np.ndarray:
    if name == "linear":
        return linear_betas(n)
    if name == "cosine":
        return cosine_betas(n)
    raise ValueError(f"unknown schedule {name!r}")


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Subset of base timesteps (``ddimN`` or comma-separated counts)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot make exactly {desired} ddim steps "
                             f"from {num_timesteps}")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, taken = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            taken.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return set(taken)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed diffusion tables, indexable by a timestep vector."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    # model-facing timestep values (respace.py's x1000/T rescale)
    model_timesteps: torch.Tensor
    num_timesteps: int

    def gather(self, table: torch.Tensor, t: torch.Tensor,
               ndim: int) -> torch.Tensor:
        """table[t] shaped to broadcast against an ndim-rank tensor."""
        out = table[t].float()
        return out.reshape(out.shape + (1,) * (ndim - 1))


def make_schedule(*, steps: int, schedule_name: str = "cosine",
                  respacing: Union[str, Sequence[int], None] = "",
                  rescale_timesteps: bool = True,
                  device=None) -> DiffusionSchedule:
    base_betas = named_betas(schedule_name, steps)
    if not ((base_betas > 0).all() and (base_betas <= 1).all()):
        raise ValueError(f"invalid betas for schedule={schedule_name!r} "
                         f"steps={steps}")
    keep = sorted(space_timesteps(steps, respacing)) if respacing \
        else list(range(steps))

    base_acp = np.cumprod(1.0 - base_betas)
    betas, last = [], 1.0
    for i in keep:
        betas.append(1.0 - base_acp[i] / last)
        last = base_acp[i]
    betas = np.array(betas, dtype=np.float64)

    n = len(betas)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    if n == 1:
        post_logvar = np.log(np.array([posterior_variance[0] + 1e-10]))
        fl_var = np.append(posterior_variance[0], betas[0:])[:1]
    else:
        post_logvar = np.log(np.append(posterior_variance[1],
                                       posterior_variance[1:]))
        fl_var = np.append(posterior_variance[1], betas[1:])
    fl_logvar = np.log(np.maximum(fl_var, 1e-20))
    model_ts = np.array(keep, dtype=np.float64)
    if rescale_timesteps:
        model_ts = model_ts * (1000.0 / steps)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(post_logvar),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas)
                                 / (1.0 - acp)),
        fixed_large_variance=f32(fl_var),
        fixed_large_log_variance=f32(fl_logvar),
        model_timesteps=f32(model_ts),
        num_timesteps=n,
    )
