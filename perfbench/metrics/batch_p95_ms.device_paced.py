"""batch_p95_ms.device_paced: ``batch_p95_ms`` in the serving cells that
the device paces, kept apart so that its bound follows their spread, not
the host-paced cells' (PERF.md, section 2)."""

from perfbench.harness import reader

read = reader("batch_p95_ms")
