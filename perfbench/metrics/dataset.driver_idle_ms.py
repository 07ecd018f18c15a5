"""dataset.driver_idle_ms: device-idle ms while the dataset driver's main
thread is inside a ``dvd.driver.*`` span (the wait for a batch, its
uploads, the drain), per batch, in the profiled stretch of a traced run
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch


def read(rec):
    return per_batch(rec, "dvd.driver.", "idle")
