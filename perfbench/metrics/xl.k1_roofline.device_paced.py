"""xl.k1_roofline.device_paced: ``k1_roofline.serve`` in the chained DiT-XL/2
cell (K1's calls counted at the caller's head dim, 72, so the zero-padding
to 128 shows as waste), read apart from the DiT-S/2 cells' (PERF.md, section
3)."""

from perfbench.harness import reader

read = reader("k1_roofline.serve")
