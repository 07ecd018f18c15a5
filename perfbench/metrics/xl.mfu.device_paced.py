"""xl.mfu.device_paced: ``mfu.serve`` in the chained DiT-XL/2 cell (model
operations counted over the chained reference,
perfbench/reference/dit_chain.py), read apart from the DiT-S/2 cells'
(PERF.md, section 3)."""

from perfbench.harness import reader

read = reader("mfu.serve")
