"""Device time launched inside the program's spans of a given name, nested
or not, in the profiled stretch of a traced run.

``perfbench/program_spans.py`` gives a launch's device time to the
outermost main-thread span open at its host stamp (``dvd.sample``, say);
here a launch counts for every name of ``NAMES`` one of whose spans is
open at that stamp, however deep it sits (``dvd.dit.blocks`` inside
``dvd.sample.step`` inside ``dvd.sample``).  The launch is matched to its
device activity by correlation id, and the activity is clipped to the
``perfbench.window`` host event, as there.

``readings(rec)`` computes once per record and keeps the result in
``rec["nested_spans"]``: {name: device ns}, a name left out where the
program recorded no span of it (a program older than the span).  None
without a profile or without the program's tracer.  The readers:
``perfbench/metrics/dit.{blocks,decoder}_device_ms.device_paced``.
"""

from __future__ import annotations

import bisect
from typing import Dict, Optional

from perfbench import program_spans
from perfbench.trace import WINDOW, _is_device, _is_launch

NAMES = ("dvd.dit.blocks", "dvd.dit.decoder")


def readings(rec: dict) -> Optional[Dict[str, int]]:
    """The record's device ns by span name (see the module's docstring),
    cached."""
    prof = (rec.get("profile") or {}).get("prof")
    if prof is None:
        return None
    if "nested_spans" not in rec:
        try:
            from dvd_tpu_torch.utils import trace
        except ImportError:
            rec["nested_spans"] = None
        else:
            rec["nested_spans"] = read(
                prof.profiler.kineto_results.events(), trace.records())
    return rec["nested_spans"]


def read(events, records, names=NAMES) -> Optional[Dict[str, int]]:
    """{name: device ns launched while a span of that name was open}, for
    each of ``names`` with a finished span; None without the window."""
    window, device, launches = None, [], {}
    for e in events:
        name = e.name()
        t0 = e.start_ns()
        if _is_device(e):
            if not name.startswith("perfbench."):
                device.append((t0, t0 + e.duration_ns(), e.correlation_id()))
        elif name == WINDOW:
            window = (t0, t0 + e.duration_ns())
        elif _is_launch(name):
            launches[e.correlation_id()] = t0
    if window is None:
        return None
    w0, w1 = window
    spans = {n: sorted((r[1], r[2]) for r in records
                       if r[0] == n and r[2] is not None) for n in names}
    spans = {n: iv for n, iv in spans.items() if iv}
    starts = {n: [a for a, _ in iv] for n, iv in spans.items()}
    out = dict.fromkeys(spans, 0)
    for a, b, corr in device:
        t = launches.get(corr)
        a, b = max(a, w0), min(b, w1)
        if t is None or b <= a:
            continue
        for n, iv in spans.items():
            k = bisect.bisect_right(starts[n], t) - 1
            if k >= 0 and t <= iv[k][1]:
                out[n] += b - a
    return out


def per_batch(rec: dict, name: str) -> Optional[float]:
    """Device ms launched inside ``name``'s spans, per ``dvd.sample`` (one
    a served batch; a span cut by the window counts in part)."""
    r = readings(rec)
    if not r or name not in r:
        return None
    sample = ((program_spans.readings(rec) or {}).get("names") or {}) \
        .get("dvd.sample")
    if not sample or sample["count"] <= 0:
        return None
    return r[name] / sample["count"] / 1e6
