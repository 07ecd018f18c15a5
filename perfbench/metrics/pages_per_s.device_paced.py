"""pages_per_s.device_paced: ``pages_per_s`` in the serving cells that the
device paces, kept apart so that its bound follows their spread, not the
host-paced cells' (PERF.md, section 2)."""

from perfbench.harness import reader

read = reader("pages_per_s")
