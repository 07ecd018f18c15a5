"""moe.blocks_device_ms.device_paced: ``dit.blocks_device_ms.device_paced``
in the chained DiT-MoE-XL/2 cell: device ms launched inside the DiT's
``dvd.dit.blocks`` spans, a batch (PERF.md, section 3)."""

from perfbench.harness import reader

read = reader("dit.blocks_device_ms.device_paced")
