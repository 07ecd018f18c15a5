"""dataset.h2d_ms: host ms of the dataset driver's ``dvd.driver.h2d`` span
(the batch's uint8 conversion, its uploads and its x_T generator), per
batch, in the profiled stretch of a traced run
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch


def read(rec):
    return per_batch(rec, "dvd.driver.h2d", "host")
