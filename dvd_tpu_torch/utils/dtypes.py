"""The port's one precision rule for its "compute in f32" steps."""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, unless it is float64, which it stays.

    The steps that ``dvd_tpu`` computes in f32 whatever the compute dtype
    (statistics, softmax, the affine epilogues, coordinates) do so here,
    and a float64 run stays float64 throughout: the CPU parity tests
    compare the training gradients in float64, below f32's rounding."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
