"""dit.blocks_device_ms.device_paced: device ms launched inside the DiT's
``dvd.dit.blocks`` spans (the blocks that run, ``models/dit.py``), per
``dvd.sample`` (a batch), in the profiled stretch of a traced run
(``perfbench/nested_spans.py``).  None where the program records no such
span."""

from perfbench.nested_spans import per_batch


def read(rec):
    return per_batch(rec, "dvd.dit.blocks")
