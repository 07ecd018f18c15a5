"""Closed-loop serving of a chained DiT: ``serve_closed``'s run (one client,
batches of pages from a seeded pool in host memory, the same check) with
the plain chained reference (``perfbench/reference/dit_chain.py``) in the
place of the shipped one, for the weights' shapes, the check and the
model's operations (``mfu``).

It also records, in a traced run, the zero-padded K1 launches of the
profiled stretch (``rec["profile"]["k1_padded"]``: {the caller's head
dim: launches}, from the program's ``attention.launches_padded``) and the
batches served in it (``rec["batches_profiled"]``); and, in every run,
the share of the checked flow values at the sampler's clamp of +-1
(``rec["flow_clamp_pct"]``, printed to standard error).

Parameters (``perfbench/traffic/<name>.json``): those of
``serve_closed``.
"""

from __future__ import annotations

import contextlib
import sys

from perfbench import harness, serving
from perfbench.reference import dit_chain
from perfbench.traffic import serve_closed


@contextlib.contextmanager
def _profiled(spans):
    """``harness.profiled``, with the padded K1 launches made inside it."""
    from dvd_tpu_torch.ops.kernels.attention import attention

    padded = getattr(attention, "launches_padded", None)
    before = dict(padded or {})
    with harness.profiled(spans) as out:
        yield out
    if padded is not None:
        out["k1_padded"] = {dh: n - before.get(dh, 0)
                            for dh, n in padded.items()}


class _Check(serving.Check):
    """``serving.Check``, counting the served flow values at the clamp."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.clamped = self.values = 0

    def batch(self, src, x_t, flow, cond):
        self.clamped += int((flow.abs() >= 1.0).sum())
        self.values += flow.numel()
        super().batch(src, x_t, flow, cond)


def run(ctx) -> dict:
    checks = []

    def check(*a, **k):
        checks.append(_Check(*a, **k))
        return checks[-1]

    saved = serving.R, serving.Check, serve_closed.profiled
    serving.R, serving.Check, serve_closed.profiled = \
        dit_chain, check, _profiled
    try:
        rec = serve_closed.run(ctx)
    finally:
        serving.R, serving.Check, serve_closed.profiled = saved
    if rec.get("pages_profiled") is not None:
        rec["batches_profiled"] = rec["pages_profiled"] / \
            int(ctx.cell.traffic["batch"])
    c = checks[-1]
    rec["flow_clamp_pct"] = 100.0 * c.clamped / max(c.values, 1)
    print(f"perfbench: {rec['flow_clamp_pct']:.4f}% of the checked flow "
          "values at the sampler's clamp", file=sys.stderr)
    return rec
