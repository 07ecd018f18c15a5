"""k2_all_roofline.device_paced: ``k2_all_roofline.serve`` in the serving
cells that the device paces, which move ``pages_per_s.device_paced``
(PERF.md, section 2)."""

from perfbench.harness import reader

read = reader("k2_all_roofline.serve")
