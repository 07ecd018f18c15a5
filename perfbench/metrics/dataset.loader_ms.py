"""dataset.loader_ms: ms the loader thread spends making batches
(``dvd.loader.batch`` spans), per batch the driver takes, in the profiled
stretch of a traced run (``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch


def read(rec):
    return per_batch(rec, "dvd.loader.batch", "host")
