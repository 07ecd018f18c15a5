"""mfu.serve: model operations of the pages completed in the profiled
stretch (counted over the reference at the configuration's shapes) over
the stretch's seconds, as a share of the bf16 peak."""

from perfbench.arith import mfu_pct


def read(rec):
    seen = rec.get("trace") or {}
    if not seen or not rec.get("flops_per_page"):
        return None
    return mfu_pct(rec["flops_per_page"] * rec["pages_profiled"],
                   seen["window_s"])
