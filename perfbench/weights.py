"""Random weights drawn from the run's seed on the device, in two large
calls, for both the served program and the reference.

The rule is the served package's own seeded init (its ``seeded_init_``),
so attention and the DiT's adaLN-zero layers carry signal: matrices and
conv kernels N(0, 1/fan_in), the adaLN-zero layers N(0, 0.02^2),
norm scales 1 + N(0, 0.02^2), BatchNorm variances U(0.5, 1.5), every other
leaf N(0, 0.02^2); one departure, ``OUTPUT`` below.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

ZERO_INIT = ("adaLN_modulation_1.", "final_layer2.linear.",
             "final_layer.linear.")
STD = 0.02
# the DiT's output projection, N(0, 0.1^2 / fan_in): flows of about a
# tenth of the page, as a trained model's, where N(0, 0.02^2) would push
# most of them past the sampler's clamp at +-1
OUTPUT = ("final_layer2.linear.weight", "final_layer.linear.weight")


def _rule(name: str, shape: Tuple[int, ...]):
    """(kind, scale, offset) of one leaf: kind 'n' draws N(0, 1), 'u'
    U(0, 1); the leaf is offset + scale * draw."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "var":
        return "u", 1.0, 0.5
    if any(name.endswith(o) for o in OUTPUT):
        return "n", 0.1 / math.sqrt(math.prod(shape[1:])), 0.0
    if leaf == "weight" and len(shape) >= 2 \
            and not any(z in name for z in ZERO_INIT):
        return "n", 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if leaf == "scale":
        return "n", STD, 1.0
    return "n", STD, 0.0


def draw_state(shapes: Dict[str, Tuple[int, ...]], seed: int,
               device) -> Dict[str, torch.Tensor]:
    """One f32 tensor per name in ``shapes`` (sorted by name), on
    ``device``: one normal and one uniform draw from a generator on the
    device seeded with ``seed``, sliced and scaled leaf by leaf."""
    names = sorted(shapes)
    rules = {n: _rule(n, tuple(shapes[n])) for n in names}
    count = {"n": 0, "u": 0}
    for n in names:
        count[rules[n][0]] += math.prod(shapes[n])
    gen = torch.Generator(device=device).manual_seed(seed)
    pools = {"n": torch.randn(count["n"], generator=gen, device=device),
             "u": torch.rand(count["u"], generator=gen, device=device)}
    at = {"n": 0, "u": 0}
    out = {}
    for n in names:
        kind, scale, offset = rules[n]
        size = math.prod(shapes[n])
        flat = pools[kind][at[kind]:at[kind] + size]
        at[kind] += size
        out[n] = (flat * scale + offset).reshape(shapes[n])
    return out
