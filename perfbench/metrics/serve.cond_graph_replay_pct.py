"""serve.cond_graph_replay_pct: the share, in %, of the calls of the
conditioning networks that the program replays from CUDA graphs (Seg's
U2NetP, the line UNet, GeoTrSegInf's mask branch) that were replays, in
the profiled stretch of a traced run.  Each call is one ``dvd.cond.graph``
span of the program (``dvd_tpu_torch/utils/graphs.py``) whose ``mode``
attribute is ``replay``, ``capture`` or ``eager``; a span counts by the
share of its length inside the ``perfbench.window`` range.  None without
a profile, or where the program records no such span."""

from perfbench.trace import WINDOW, _is_device

SPAN = "dvd.cond.graph"


def read(rec):
    prof = (rec.get("profile") or {}).get("prof")
    if prof is None:
        return None
    try:
        from dvd_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = [r for r in trace.records()
             if r[0] == SPAN and r[2] is not None and r[2] > r[1]]
    if not spans:
        return None
    window = next(((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == WINDOW and not _is_device(e)), None)
    if window is None:
        return None
    w0, w1 = window
    calls = replays = 0.0
    for _, t0, t1, _, _, attrs in spans:
        share = max(0, min(t1, w1) - max(t0, w0)) / (t1 - t0)
        calls += share
        if attrs.get("mode") == "replay":
            replays += share
    return 100.0 * replays / calls if calls > 0 else None
