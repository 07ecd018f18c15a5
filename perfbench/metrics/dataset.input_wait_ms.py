"""dataset.input_wait_ms: ms the dataset driver waits for its next batch
from the loader thread (``prefetched_batches``), per batch, in the traced
run's second stretch."""

from perfbench.harness import mean_ms


def read(rec):
    return mean_ms((rec.get("spans") or {}).get("input_wait"))
