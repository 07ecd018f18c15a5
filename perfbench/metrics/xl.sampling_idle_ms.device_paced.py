"""xl.sampling_idle_ms.device_paced: ``serve.sampling_idle_ms`` in the chained
DiT-XL/2 cell, read apart from the DiT-S/2 cells' (PERF.md, section 3)."""

from perfbench.harness import reader

read = reader("serve.sampling_idle_ms")
