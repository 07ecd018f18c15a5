"""k1_roofline.serve: the sum of the K1 calls' bounds (operations and
bytes from their shapes, ``perfbench/arith.py``) over the device time of
everything those calls launched, in the traced run's profiled stretch."""

from perfbench.arith import roofline_pct


def read(rec):
    calls = (rec.get("calls") or {}).get("k1")
    seen = (rec.get("trace") or {}).get("range_s") or {}
    if not calls or not seen.get("perfbench.k1"):
        return None
    return roofline_pct(calls, seen["perfbench.k1"])
