"""dataset.drain_ms: host ms of the dataset driver's ``dvd.driver.drain``
span (a batch's pages and flows pulled to the host, its writes queued),
per batch, in the profiled stretch of a traced run
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch


def read(rec):
    return per_batch(rec, "dvd.driver.drain", "host")
