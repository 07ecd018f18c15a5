"""moe.layer_device_ms.device_paced: device ms launched inside the
routed-expert layer's ``dvd.dit.moe`` spans (one a block, the router, the
permutation, the grouped GEMMs, the shared expert and the combine), per
``dvd.sample`` (a batch), in the profiled stretch of a traced run
(``perfbench/moe_spans.py``).  None where the program records no such
span."""

from perfbench.moe_spans import per_batch


def read(rec):
    return per_batch(rec, "dvd.dit.moe")
