"""moe.load_max_over_mean.device_paced: the tokens routed to the busiest
expert over the experts' mean, summed over the blocks in the profiled
stretch (the program's device counter ``dvd.dit.moe.expert_tokens``,
read after the stretch; ``perfbench/traffic/serve_moe.py``).  1 is an
even load; None without the counter."""

from perfbench import moe_spans


def read(rec):
    return moe_spans.load_max_over_mean(rec)
