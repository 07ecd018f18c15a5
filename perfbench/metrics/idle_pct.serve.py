"""idle_pct.serve: share of the profiled stretch in which no device
activity ran (the union of activity intervals)."""


def read(rec):
    seen = rec.get("trace") or {}
    if not seen.get("window_s"):
        return None
    return 100.0 * (1.0 - seen["busy_s"] / seen["window_s"])
