"""Closed-loop serving: one client hands the served pipeline a batch of
pages held in host memory (``DewarpPipeline.dewarp_flow`` and
``unwarp_fixed``), waits until the unwarped pages and flows are back in
host memory, and sends the next.  The pages cycle through a seeded pool;
each batch's x_T comes from a generator seeded by (seed, batch index).

Parameters (``perfbench/traffic/<name>.json``): ``batch`` pages a batch,
``pool_batches`` distinct batches in the pool, ``warm_batches`` before
the window, ``check_pages`` pages the check compares (whole batches,
drawn from the seed), ``trace_seconds`` of the traced run profiled.
"""

from __future__ import annotations

import random
import time

import torch

from perfbench import pages as P
from perfbench import serving
from perfbench.harness import Spans, patch_kernels, profiled, subseed, sync


def run(ctx) -> dict:
    from dvd_tpu_torch.evaluation import pipeline

    tr, dev, seed = ctx.cell.traffic, ctx.device, ctx.seed
    b = int(tr["batch"])
    pipe, cfg = serving.build_pipeline(ctx.cell.config, seed, dev, ctx.over)
    size = cfg.model.source_size
    gen = torch.Generator(device=dev).manual_seed(subseed(seed, "pages"))
    pool = [P.pages(b, size, size, gen).cpu() for _ in
            range(int(tr["pool_batches"]))]
    order = random.Random(subseed(seed, "order"))
    xt_gen = torch.Generator(device=dev)
    spans = Spans(dev)
    seen = {}
    serving.capture(pipe, seen)
    if ctx.trace:
        pipe.build_conditioning = spans.stage("conditioning",
                                              pipe.build_conditioning)
        pipe.sampling_impl = spans.stage("sampling", pipe.sampling_impl)
    unwarp = spans.stage("unwarp", lambda s, f: pipeline.unwarp_fixed(s, f))

    def serve(i: int):
        """Batch ``i``: (pool index, host flows, host pages, seconds); the
        conditioning streams stay in ``seen``."""
        k = order.randrange(len(pool))
        t0 = time.perf_counter()
        src = pool[k].to(dev)
        xt_gen.manual_seed(subseed(seed, f"xt{i}"))
        flow = pipe.dewarp_flow(src, generator=xt_gen)
        out = unwarp(src, flow)
        flow_h, out_h = flow.float().cpu(), out.cpu()
        return k, flow_h, out_h, time.perf_counter() - t0

    for i in range(int(tr["warm_batches"])):
        serve(-1 - i)
    sync(dev)
    rec = {"setup_s": ctx.age()}

    keep = max(1, int(tr["check_pages"]) // b)
    sample = random.Random(subseed(seed, "sample"))
    kept, lat, pages_done, i = [], [], 0, 0
    undo, prof_cm, prof, pages_a = None, None, {}, 0
    if ctx.trace:
        # the profiler starts before the window: its start takes seconds
        undo = patch_kernels(spans)
        prof_cm = profiled(spans)
        prof = prof_cm.__enter__()
    t_open = time.perf_counter()
    deadline = t_open + ctx.seconds
    stretch_a = min(float(tr["trace_seconds"]), ctx.seconds / 2)
    while time.perf_counter() < deadline:
        if prof_cm is not None and time.perf_counter() >= t_open + stretch_a:
            prof_cm.__exit__(None, None, None)
            prof_cm = None
            pages_a = pages_done
            spans.mode = "sync"
            # the synchronised stretch gets the rest of the window's length
            deadline = time.perf_counter() + ctx.seconds - stretch_a
        k, flow_h, out_h, sec = serve(i)
        lat.append(sec)
        pages_done += b
        # a uniform sample of ``keep`` batches (reservoir)
        item = (i, k, flow_h, out_h, seen.pop("cond"))
        if len(kept) < keep:
            kept.append(item)
        else:
            j = sample.randrange(i + 1)
            if j < keep:
                kept[j] = item
        i += 1
    window = time.perf_counter() - t_open
    if prof_cm is not None:
        prof_cm.__exit__(None, None, None)
        pages_a = pages_done
    spans.mode = "off"
    if undo:
        undo()
    rec.update(window_s=window, pages=pages_done, latencies=lat,
               memory_peak_bytes=torch.cuda.max_memory_allocated()
               if dev.type == "cuda" else 0)
    if ctx.trace:
        rec.update(spans=spans.seconds, calls=spans.calls, profile=prof,
                   pages_profiled=pages_a,
                   flops_per_page=serving.meta_flops(ctx.cell.config, b) / b)

    serving.free_program(pipe)
    del pipe
    with serving.reference_precision():
        check = serving.Check(serving.build_reference(ctx.cell.config, seed,
                                                      dev), ctx.controls)
        for bi, k, flow_h, out_h, cond in kept:
            src = pool[k].to(dev)
            check.batch(src, check.ref.draw_xt(subseed(seed, f"xt{bi}"), b),
                        flow_h, cond)
            flow = flow_h.to(dev)
            check.pages(out_h, lambda dt: serving.R.unwarp_fixed(src, flow,
                                                                 dt))
    rec["checks"] = check.result()
    rec["control_checks"] = check.control_result()
    rec["attempted"], rec["failed"] = pages_done, 0
    return rec
