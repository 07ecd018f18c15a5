"""batch_p95_ms: the 95th percentile (nearest rank) of every batch's
latency in the window, from handing its pages in host memory to the entry
until its pages and flows are back in host memory."""

import math


def read(rec):
    lat = sorted(rec.get("latencies") or [])
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
