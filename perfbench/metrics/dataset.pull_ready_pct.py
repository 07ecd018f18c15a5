"""dataset.pull_ready_pct: the share, in %, of the dataset driver's drains
whose batch was already back in host memory when the drain began, in the
profiled stretch of a traced run.  On a card the driver pulls each batch's
pages and flows into pinned host memory on a stream of its own once the
batch's unwarp is done; each drain is one ``dvd.driver.drain`` span of the
program (``dvd_tpu_torch/evaluation/driver.py``) whose ``ready``
attribute says whether that pull had completed; a span counts by the share
of its length inside the ``perfbench.window`` range.  None without a
profile, or where the program records no drain span with ``ready``."""

from perfbench.trace import WINDOW, _is_device

SPAN = "dvd.driver.drain"


def read(rec):
    prof = (rec.get("profile") or {}).get("prof")
    if prof is None:
        return None
    try:
        from dvd_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = [r for r in trace.records()
             if r[0] == SPAN and r[2] is not None and r[2] > r[1]
             and "ready" in r[5]]
    if not spans:
        return None
    window = next(((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == WINDOW and not _is_device(e)), None)
    if window is None:
        return None
    w0, w1 = window
    drains = ready = 0.0
    for _, t0, t1, _, _, attrs in spans:
        share = max(0, min(t1, w1) - max(t0, w0)) / (t1 - t0)
        drains += share
        if attrs["ready"]:
            ready += share
    return 100.0 * ready / drains if drains > 0 else None
