"""Readings of the program's own spans (``dvd_tpu_torch/utils/trace.py``)
laid over the profiled stretch of a traced run: how much device work each
span launched, how long the device stood idle while the program was inside
it, and how long each span held its thread.

Both sources share one clock: the spans are stamped with
``time.time_ns()``, the Unix-epoch nanoseconds of the profiler's host
events, and the profiler puts the device's activities on the same clock.
Both are clipped to the ``perfbench.window`` host event.

- Device-busy time is the union of the device's activities, skipping the
  mirrors of the harness's own ``record_function`` ranges, as
  ``perfbench/trace.py`` counts it for ``idle_pct``; idle time is the rest
  of the window.
- A launch (a host ``cuda*`` call) belongs to the outermost span open on
  the launching thread at its host stamp, and its device activity is
  matched to it by correlation id.  The profiler's thread ids and the
  tracer's ``threading.get_ident()`` are different numbers, so the main
  thread is taken to be the one whose records hold ``dvd.cond``: the
  program launches device work only from its main thread, and every
  launch is laid over that thread's spans.
- Idle time belongs to the outermost main-thread span open at that
  moment.
- A span's count is the share of its length inside the window, summed,
  so a span cut by the window's edge counts in part.

``readings(rec)`` computes once per record and keeps the result in
``rec["program_spans"]``; it is None without a profile (a ``--trace 0``
run) or without the program's tracer (a program older than it).  The
readers: ``perfbench/metrics/serve.{conditioning,sampling}_{device,idle}_ms``
(per ``dvd.cond`` or ``dvd.sample``; the same with ``.device_paced`` in the
cells the device paces) and ``perfbench/metrics/dataset.{h2d,drain,
driver_idle,loader}_ms`` (per batch: per ``dvd.driver.h2d``, which the
dataset driver opens once a batch).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.trace import WINDOW, _is_device, _is_launch, _merge

COND = "dvd.cond"
BATCH = "dvd.driver.h2d"


def readings(rec: dict) -> Optional[dict]:
    """The record's span readings (see the module's docstring), cached."""
    prof = (rec.get("profile") or {}).get("prof")
    if prof is None:
        return None
    if "program_spans" not in rec:
        try:
            from dvd_tpu_torch.utils import trace
        except ImportError:
            rec["program_spans"] = None
        else:
            rec["program_spans"] = read(
                prof.profiler.kineto_results.events(), trace.records())
    return rec["program_spans"]


def _measure(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(events, records) -> Optional[dict]:
    """From the profiler's events and the tracer's records: for each span
    name, ``count``, ``host_ns`` (the time its spans held their threads),
    and for the main thread's outermost spans ``device_ns`` (device time
    launched inside them) and ``idle_ns`` (device-idle time inside them);
    ``window_ns`` and ``idle_ns`` of the whole window.  None where the
    window, the device or ``dvd.cond`` is missing."""
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
    spans = [r for r in records if r[2] is not None]
    main = next((r[3] for r in spans if r[0] == COND), None)
    if window is None or not device or main is None:
        return None
    w0, w1 = window
    busy = _merge([(max(a, w0), min(b, w1)) for a, b, _ in device
                   if b > w0 and a < w1])
    idle, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)

    names: Dict[str, dict] = defaultdict(lambda: dict(
        count=0.0, host_ns=0, device_ns=0, idle_ns=0))
    outer = []                   # the main thread's outermost spans
    for name, t0, t1, thread, parent, _ in spans:
        a, b = max(t0, w0), min(t1, w1)
        if thread == main and parent is None:
            outer.append((t0, t1, name))
        if b <= a:
            continue
        n = names[name]
        n["count"] += (b - a) / (t1 - t0)
        n["host_ns"] += b - a
    outer.sort()
    by_name = defaultdict(list)
    for t0, t1, name in outer:
        by_name[name].append((t0, t1))
    for name, iv in by_name.items():
        if name in names:
            names[name]["idle_ns"] = _measure(iv, idle)

    starts = [s[0] for s in outer]
    for a, b, corr in device:
        t = launches.get(corr)
        a, b = max(a, w0), min(b, w1)
        if t is None or b <= a:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= outer[k][1] and outer[k][2] in names:
            names[outer[k][2]]["device_ns"] += b - a
    return {"window_ns": w1 - w0, "idle_ns": sum(b - a for a, b in idle),
            "names": dict(names)}


def per_span(rec: dict, name: str, what: str) -> Optional[float]:
    """``what`` (``device``, ``idle`` or ``host``) ms of the spans called
    ``name``, per span."""
    r = readings(rec)
    n = (r or {}).get("names", {}).get(name)
    if not n or n["count"] <= 0:
        return None
    return n[what + "_ns"] / n["count"] / 1e6


def per_batch(rec: dict, prefix: str, what: str) -> Optional[float]:
    """``what`` ms of every span whose name starts with ``prefix``, per
    batch of the dataset driver (``dvd.driver.h2d`` spans)."""
    r = readings(rec)
    names = (r or {}).get("names", {})
    batches = names.get(BATCH, {}).get("count", 0.0)
    if batches <= 0:
        return None
    return sum(n[what + "_ns"] for k, n in names.items()
               if k.startswith(prefix)) / batches / 1e6
