"""serve.conditioning_device_ms: device ms launched inside the program's
``dvd.cond`` span (``build_conditioning``), per ``dvd.cond``, in the
profiled stretch of a traced run (``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_span


def read(rec):
    return per_span(rec, "dvd.cond", "device")
