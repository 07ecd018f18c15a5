"""Readings from a ``torch.profiler`` trace of a stretch of the run: the
device's busy time (the union of its activity intervals, not a sum), the
idle gaps and what the host was doing in each, device time by operation,
and the device time of every call made inside a ``record_function`` range
(each device activity belongs to the range in which the host launched
it: the launch is matched to the activity by its correlation id)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "perfbench.window"
STAGE = "perfbench.stage."


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _is_launch(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn")


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(prof, ranges: Tuple[str, ...] = (), top: int = 10) -> Dict:
    """Readings of a finished profile whose stretch is the
    ``perfbench.window`` range: ``window_s``, ``busy_s``, ``device_ops``
    and ``idle_gaps`` (the ``top`` largest, [name, seconds]) and
    ``range_s`` (device seconds launched inside each range named in
    ``ranges``)."""
    events = prof.profiler.kineto_results.events()
    host, device, launches = [], [], {}
    window = None
    for e in events:
        name = e.name()
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        if _is_device(e):
            if name.startswith("perfbench."):
                continue        # the ranges' mirrors on the device's timeline
            device.append((t0, t1, name, e.correlation_id()))
        elif name == WINDOW:
            window = (t0, t1)
        elif _is_launch(name):
            launches[e.correlation_id()] = t0
        else:
            host.append((t0, t1, name))
    if window is None or not device:
        return {}
    w0, w1 = window
    inside = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in device
              if b > w0 and a < w1]
    busy = _merge([(a, b) for a, b, _, _ in inside])
    busy_ns = sum(b - a for a, b in busy)
    by_op = defaultdict(int)
    for a, b, n, _ in inside:
        by_op[n] += b - a
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]

    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [[_host_label(host, g0), (g1 - g0) / 1e9] for g0, g1 in gaps]

    spans = sorted((a, b, n) for a, b, n in host if n in ranges)
    starts = [s[0] for s in spans]
    range_ns = defaultdict(int)
    for a, b, _, corr in device:
        t = launches.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            range_ns[spans[i][2]] += b - a
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": idle,
            "range_s": {n: range_ns[n] / 1e9 for n in ranges}}


def _host_label(host, t: int) -> str:
    """'<stage>: <innermost host op>' open on the host at time ``t``."""
    stage, op, op_start = "outside stages", "idle host", -1
    for a, b, n in host:
        if a <= t < b:
            if n.startswith(STAGE):
                stage = n[len(STAGE):]
            elif a > op_start and not n.startswith("perfbench."):
                op, op_start = n, a
    return f"{stage}: {op}"[:120]
