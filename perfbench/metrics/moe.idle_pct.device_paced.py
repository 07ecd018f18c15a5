"""moe.idle_pct.device_paced: ``idle_pct.serve`` in the chained
DiT-MoE-XL/2 cell, read apart from the other cells' (PERF.md, section
3)."""

from perfbench.harness import reader

read = reader("idle_pct.serve")
