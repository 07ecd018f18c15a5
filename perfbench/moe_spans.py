"""Readings of the routed-expert layer (``dvd_tpu_torch/models/moe.py``)
in the profiled stretch of a traced run: device time inside its spans,
the grouped GEMMs' bound from the spans' attributes, and the load on the
busiest expert from the program's counter.

``readings(rec)`` is ``nested_spans.read`` over the layer's span names,
computed once per record and kept in ``rec["moe_spans"]``: {name: device
ns launched while a span of that name was open}, a name left out where
the program recorded no span of it (a program without routed experts).
The readers: ``perfbench/metrics/moe.*.device_paced``.
"""

from __future__ import annotations

from typing import Dict, Optional

from perfbench import arith, nested_spans, program_spans
from perfbench.trace import WINDOW

LAYER, EXPERTS = "dvd.dit.moe", "dvd.dit.moe.experts"
NAMES = (LAYER, "dvd.dit.moe.route", EXPERTS, "dvd.dit.moe.shared",
         "dvd.dit.moe.combine")


def _records():
    try:
        from dvd_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records()


def _events(rec: dict):
    prof = (rec.get("profile") or {}).get("prof")
    return None if prof is None else prof.profiler.kineto_results.events()


def readings(rec: dict) -> Optional[Dict[str, int]]:
    """The record's device ns by span name (see the module's docstring),
    cached; None without a profile or without the program's tracer."""
    if "moe_spans" not in rec:
        events, records = _events(rec), _records()
        rec["moe_spans"] = None if events is None or records is None else \
            nested_spans.read(events, records, names=NAMES)
    return rec["moe_spans"]


def per_batch(rec: dict, *names: str) -> Optional[float]:
    """Device ms launched inside the spans of ``names`` (summed), per
    ``dvd.sample`` (a served batch); None where one of them is absent."""
    r = readings(rec)
    if not r or any(n not in r for n in names):
        return None
    sample = ((program_spans.readings(rec) or {}).get("names") or {}) \
        .get("dvd.sample")
    if not sample or sample["count"] <= 0:
        return None
    return sum(r[n] for n in names) / sample["count"] / 1e6


def experts_cost(attrs: dict):
    """(operations, bytes) of one call's routed experts from its
    ``dvd.dit.moe`` span's attributes: tokens x top_k rows through three
    (dim x inner) products of 2 operations a multiply-add; the gathered
    rows and the experts' weights read once, the rows' results written
    once."""
    rows = attrs["tokens"] * attrs["top_k"]
    d, inner, size = attrs["dim"], attrs["inner"], attrs["itemsize"]
    ops = 6.0 * rows * d * inner
    nbytes = size * (2 * rows * d + 3 * attrs["experts"] * d * inner)
    return ops, float(nbytes)


def gemm_roofline(rec: dict) -> Optional[float]:
    """The bounds of the routed experts' calls inside the window over the
    device time launched inside ``dvd.dit.moe.experts`` there, %."""
    r, events, records = readings(rec), _events(rec), _records()
    if not r or EXPERTS not in r or events is None:
        return None
    window = next(((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.name() == WINDOW), None)
    if window is None:
        return None
    calls = [experts_cost(records[p][5]) for name, t0, t1, _, p, _ in records
             if name == EXPERTS and t1 is not None and p is not None
             and records[p][0] == LAYER
             and window[0] <= t0 and t1 <= window[1]]
    return arith.roofline_pct(calls, r[EXPERTS] / 1e9)


def load_max_over_mean(rec: dict) -> Optional[float]:
    """The busiest expert's tokens over the experts' mean, from the
    counter read over the profiled stretch."""
    counts = (rec.get("profile") or {}).get("moe_expert_tokens")
    if not counts or sum(counts) <= 0:
        return None
    return max(counts) / (sum(counts) / len(counts))
