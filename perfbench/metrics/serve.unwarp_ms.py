"""serve.unwarp_ms: host-clock ms of the unwarp stage per batch, the
device synchronised before and after each call (the traced run's second
stretch)."""

from perfbench.harness import mean_ms


def read(rec):
    return mean_ms((rec.get("spans") or {}).get("unwarp"))
