"""serve.sampling_device_ms: device ms launched inside the program's
``dvd.sample`` span (``sampling_impl``), per ``dvd.sample``, in the
profiled stretch of a traced run (``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_span


def read(rec):
    return per_span(rec, "dvd.sample", "device")
