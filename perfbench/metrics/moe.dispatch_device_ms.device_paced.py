"""moe.dispatch_device_ms.device_paced: device ms launched inside the
routed-expert layer's ``dvd.dit.moe.route`` (router, top-k, the
permutation into expert order) and ``dvd.dit.moe.combine`` (the weighted
sum back in token order) spans, a batch (``perfbench/moe_spans.py``).
None where the program records no such span."""

from perfbench.moe_spans import per_batch


def read(rec):
    return per_batch(rec, "dvd.dit.moe.route", "dvd.dit.moe.combine")
