"""Closed-loop serving of a chained DiT with routed experts (DiT-MoE):
``serve_closed``'s run (one client, batches of pages from a seeded pool in
host memory) with the plain chained DiT-MoE reference
(``perfbench/reference/dit_moe.py``) in the place of the shipped one, for
the weights' shapes, the check and the model's operations (``mfu``).

- Every batch's served routes are captured by wrapping each expert
  layer's routing method (``models/moe.py`` ``MoE.route``): the (tokens,
  top_k) expert indices of each call, device tensors kept without a copy
  beside the batch's conditioning streams.  The check hands the sampled
  batches' routes to the reference, which follows them
  (``dit_moe.Reference.follow``), and adds ``route_flip_pct``: the share
  of (step, block, token) decisions whose top-k expert set in the
  reference's own float32 routing differs from the served one (the
  float8 control: its own routing against the float32 reference's).
- A traced run records the tokens each expert received in the profiled
  stretch (``rec["profile"]["moe_expert_tokens"]``, from the program's
  counter ``dvd.dit.moe.expert_tokens``; absent where the program has no
  such counter) and the batches served in it (``rec["batches_profiled"]``).
  Its model operations are the routed work, ``top_k`` experts and the
  shared one a token (the reference's count on the meta device).

Parameters (``perfbench/traffic/<name>.json``): those of
``serve_closed``.
"""

from __future__ import annotations

import contextlib

from perfbench import harness, serving
from perfbench.reference import dit_moe
from perfbench.traffic import serve_closed

COUNTER = "dvd.dit.moe.expert_tokens"


def _counts():
    """The program's per-expert counter as a list, or None."""
    try:
        from dvd_tpu_torch.utils import trace
    except ImportError:
        return None
    buf = getattr(trace, "counts", dict)().get(COUNTER)
    return None if buf is None else buf.tolist()


@contextlib.contextmanager
def _profiled(spans):
    """``harness.profiled``, with the tokens each expert received inside
    it."""
    before = _counts()
    with harness.profiled(spans) as out:
        yield out
    after = _counts()
    if after is not None:
        out["moe_expert_tokens"] = [a - b for a, b in
                                    zip(after, before or [0] * len(after))]


def capture(pipe, seen: dict) -> None:
    """``serving.capture``, and each batch's served routes in
    ``seen["cond"]["routes"]``: one (tokens, top_k) tensor of experts per
    call of an expert layer, in the order served."""
    _base_capture(pipe, seen)
    build = pipe.build_conditioning

    def build_conditioning(source512):
        routes = seen["routes"] = []
        out = build(source512)
        seen["cond"]["routes"] = routes
        return out

    def wrap(route):
        def wrapped(x):
            idx, weights = route(x)
            seen["routes"].append(idx)
            return idx, weights
        return wrapped

    pipe.build_conditioning = build_conditioning
    for mod in pipe.dit.modules():
        if callable(getattr(mod, "route", None)):
            mod.route = wrap(mod.route)


_base_capture = serving.capture


class _Check(serving.Check):
    """``serving.Check``, the reference following each batch's served
    routes, and ``route_flip_pct`` beside the other numbers."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.flips = {"program": [0, 0], "control": [0, 0]}

    def batch(self, src, x_t, flow, cond):
        cond = dict(cond)
        served = cond.pop("routes")
        self.ref.follow(served)
        super().batch(src, x_t, flow, cond)
        runs = self.ref.runs        # the reference's, then the control's
        pairs = {"program": (served, runs[0])}
        if self.control is not None and len(runs) > 1:
            pairs["control"] = (runs[1], runs[0])
        for side, (a, b) in pairs.items():
            differ, total = dit_moe.flips(a, b)
            self.flips[side][0] += differ
            self.flips[side][1] += total
        self.ref.follow(None)

    def _with_flips(self, out, side):
        differ, total = self.flips[side]
        out["route_flip_pct"] = 100.0 * differ / total if total else \
            float("inf")
        return out

    def result(self) -> dict:
        return self._with_flips(super().result(), "program")

    def control_result(self):
        out = super().control_result()
        return None if out is None else self._with_flips(out, "control")


def run(ctx) -> dict:
    saved = (serving.R, serving.Check, serving.capture,
             serve_closed.profiled)
    serving.R, serving.Check, serving.capture, serve_closed.profiled = \
        dit_moe, _Check, capture, _profiled
    try:
        rec = serve_closed.run(ctx)
    finally:
        (serving.R, serving.Check, serving.capture,
         serve_closed.profiled) = saved
    if rec.get("pages_profiled") is not None:
        rec["batches_profiled"] = rec["pages_profiled"] / \
            int(ctx.cell.traffic["batch"])
    return rec
