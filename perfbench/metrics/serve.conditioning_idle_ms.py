"""serve.conditioning_idle_ms: device-idle ms while the program's main
thread is inside its ``dvd.cond`` span (``build_conditioning``), per
``dvd.cond``, in the profiled stretch of a traced run
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_span


def read(rec):
    return per_span(rec, "dvd.cond", "idle")
