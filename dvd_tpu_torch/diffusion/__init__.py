from dvd_tpu_torch.diffusion.likelihood import (
    calc_bpd_loop,
    discretized_gaussian_log_likelihood,
    normal_kl,
    prior_bpd,
    vb_terms_bpd,
)
from dvd_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    cosine_betas,
    linear_betas,
    make_schedule,
    space_timesteps,
)

__all__ = [
    "DiffusionSchedule",
    "calc_bpd_loop",
    "cosine_betas",
    "discretized_gaussian_log_likelihood",
    "linear_betas",
    "make_schedule",
    "normal_kl",
    "prior_bpd",
    "space_timesteps",
    "vb_terms_bpd",
]
