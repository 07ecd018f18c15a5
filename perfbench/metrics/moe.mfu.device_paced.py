"""moe.mfu.device_paced: ``mfu.serve`` in the chained DiT-MoE-XL/2 cell,
its model operations the routed work (``top_k`` experts and the shared
one a token, counted over perfbench/reference/dit_moe.py on the meta
device), read apart from the other cells' (PERF.md, section 3)."""

from perfbench.harness import reader

read = reader("mfu.serve")
