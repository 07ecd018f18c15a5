"""serve.sampling_idle_ms: device-idle ms while the program's main thread
is inside its ``dvd.sample`` span (``sampling_impl``), per
``dvd.sample``, in the profiled stretch of a traced run
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_span


def read(rec):
    return per_span(rec, "dvd.sample", "idle")
