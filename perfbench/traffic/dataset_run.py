"""The corpus path: ``evaluation.driver.run_benchmark`` over a dataset of
stand-in page photos at their native sizes on a fixed canvas, as
``run_sampling --eval_dataset`` drives it: the loader thread, the uint8
canvases' host-to-device copies, conditioning, sampling, the native-size
unwarp, the drain to the host and the writer pool.

The dataset (``run_benchmark``'s ``batches`` contract) cycles a pool of pages
made at set-up: the same set of page sizes for every seed (drawn from a
fixed seed), the seed choosing their content and their order.  It stops
yielding when the window closes.  ``run_benchmark``'s PNG writer is swapped for
one that keeps only the pages the check compares (PNG encoding needs PIL,
and the check reads the pages); the coordinate maps are written as ``run_benchmark`` writes them.

Parameters: ``batch``, ``canvas``, ``sides`` (the page sides' range),
``pool_pages``, ``warm_batches``, ``check_pages``, ``trace_seconds``.
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from perfbench import pages as P
from perfbench import serving
from perfbench.harness import Spans, patch_kernels, profiled, subseed, sync


class Pages:
    """Batches of the pool's pages, padded into the canvas, in a seeded
    order, until ``deadline`` (or for ``limit`` batches)."""

    def __init__(self, pool, sources, canvas: int, seed: int):
        self.pool, self.sources, self.canvas = pool, sources, canvas
        self.rng = random.Random(seed)
        self.items = []          # pool index of page k
        self.deadline = None
        self.limit = None

    def __len__(self):
        return self.limit * 4 if self.limit else 1 << 30

    def batches(self, batch_size: int):
        nb = 0
        while True:
            if self.limit is not None and nb >= self.limit:
                return
            if self.deadline is not None \
                    and time.perf_counter() >= self.deadline:
                return
            idx = [self.rng.randrange(len(self.pool))
                   for _ in range(batch_size)]
            k0 = len(self.items)
            self.items.extend(idx)
            padded = []
            for i in idx:
                page = self.pool[i]
                canvas = np.zeros((self.canvas, self.canvas, 3), np.uint8)
                canvas[:page.shape[0], :page.shape[1]] = page
                padded.append(canvas)
            yield {"source_image": np.stack([self.sources[i] for i in idx]),
                   "source_padded": np.stack(padded),
                   "hw": np.array([self.pool[i].shape[:2] for i in idx],
                                  np.int32),
                   "paths": [f"page_{k0 + j:07d}.png"
                             for j in range(batch_size)],
                   "count": batch_size}
            nb += 1


class Keeper:
    """The writer ``run_benchmark`` calls for each page: keeps the pages of the
    ``keep`` batches with the smallest seeded keys (a uniform sample of
    whole batches, whatever order the writer threads run in)."""

    def __init__(self, keep: int, batch: int, seed: int):
        self.keep, self.batch, self.seed = keep, batch, seed
        self.kept = {}           # batch index -> {page index: array}
        self.lock = threading.Lock()

    def key(self, bi: int) -> int:
        return zlib.crc32(f"{self.seed}:{bi}".encode())

    def __call__(self, path: str, arr: np.ndarray) -> None:
        k = int(os.path.basename(path).split("_")[-1].split(".")[0])
        bi = k // self.batch
        with self.lock:
            self.kept.setdefault(bi, {})[k] = np.array(arr, copy=True)
            if len(self.kept) > self.keep:
                del self.kept[max(self.kept, key=self.key)]


def _pool(tr, seed, size, dev):
    """(pages uint8 (h, w, 3), their 512^2 [0, 1] sources), host arrays."""
    lo, hi = tr["sides"]
    sizes = torch.randint(lo, hi, (int(tr["pool_pages"]), 2),
                          generator=torch.Generator().manual_seed(0)).tolist()
    gen = torch.Generator(device=dev).manual_seed(subseed(seed, "pages"))
    pool, sources = [], []
    for h, w in sizes:
        page = P.photo_u8(h, w, gen)
        sources.append(P.source_of(page, size).cpu().numpy())
        pool.append(page.cpu().numpy())
    return pool, sources


def run(ctx) -> dict:
    from dvd_tpu_torch.evaluation import driver

    tr, dev, seed = ctx.cell.traffic, ctx.device, ctx.seed
    b, canvas = int(tr["batch"]), int(tr["canvas"])
    pipe, cfg = serving.build_pipeline(ctx.cell.config, seed, dev, ctx.over)
    pool, sources = _pool(tr, seed, cfg.model.source_size, dev)
    out_root = tempfile.mkdtemp(prefix="perfbench-")
    keeper = Keeper(max(1, int(tr["check_pages"]) // b), b, seed)
    real = {n: getattr(driver, n) for n in
            ("save_png", "_sync", "prefetched_batches", "unwarp_u8")}
    spans = Spans(dev)
    closed = {}
    xt_seed = subseed(seed, "xt")
    try:
        warm = Pages(pool, sources, canvas, subseed(seed, "warm"))
        warm.limit = int(tr["warm_batches"])
        driver.save_png = lambda path, arr: None
        driver.run_benchmark(pipe, warm, os.path.join(out_root, "warm"),
                             batch_size=b, seed=xt_seed, mesh=None)
        sync(dev)
        rec = {"setup_s": ctx.age()}

        ds = Pages(pool, sources, canvas, subseed(seed, "order"))
        driver.save_png = keeper
        conds, calls = {}, [0]
        seen = {}
        serving.capture(pipe, seen)
        captured = pipe.build_conditioning

        def conditioning(source512):
            # batch bi's streams (its src_feat joins them in sampling), for
            # the batches the keeper's rule keeps (run_benchmark's timings
            # after the loop call it again: not kept)
            out = captured(source512)
            bi = calls[0]
            calls[0] += 1
            if bi < len(ds.items) // b:
                conds[bi] = seen["cond"]
                if len(conds) > keeper.keep:
                    del conds[max(conds, key=keeper.key)]
            return out

        pipe.build_conditioning = conditioning

        def timed_sync(d):
            real["_sync"](d)
            if "end" not in closed and ds.deadline is not None \
                    and time.perf_counter() >= ds.deadline:
                closed["end"] = time.perf_counter()

        driver._sync = timed_sync
        prof_cm, prof, undo = None, {}, None
        if ctx.trace:
            pipe.build_conditioning = spans.stage("conditioning",
                                                  pipe.build_conditioning)
            pipe.sampling_impl = spans.stage("sampling", pipe.sampling_impl)
            driver.unwarp_u8 = spans.stage("unwarp", real["unwarp_u8"])
            undo = patch_kernels(spans)
            consumed = [0]

            def batches(dataset, batch_size, depth=2):
                nonlocal prof_cm
                for item in spans.waited("input_wait", real[
                        "prefetched_batches"](dataset, batch_size, depth)):
                    if prof_cm is not None and \
                            time.perf_counter() >= closed["stretch_a"]:
                        prof_cm.__exit__(None, None, None)
                        prof_cm = None
                        closed["pages_a"] = consumed[0] * batch_size
                        spans.mode = "sync"
                        # the synchronised stretch gets the rest of the
                        # window's length
                        ds.deadline = time.perf_counter() + ctx.seconds \
                            - closed["stretch_len"]
                    consumed[0] += 1
                    yield item

            driver.prefetched_batches = batches
            # the profiler starts before the window: its start takes seconds
            prof_cm = profiled(spans)
            prof = prof_cm.__enter__()
        t_open = time.perf_counter()
        ds.deadline = t_open + ctx.seconds
        if ctx.trace:
            closed["stretch_len"] = min(float(tr["trace_seconds"]),
                                        ctx.seconds / 2)
            closed["stretch_a"] = t_open + closed["stretch_len"]
        stats = driver.run_benchmark(pipe, ds, os.path.join(out_root, "run"),
                                     batch_size=b, seed=xt_seed,
                                     save_coord_maps=True, mesh=None)
        if prof_cm is not None:
            prof_cm.__exit__(None, None, None)
            closed["pages_a"] = consumed[0] * b
        spans.mode = "off"
        if undo:
            undo()
        end = closed.get("end", time.perf_counter())
        rec.update(window_s=end - t_open, pages=int(stats["images"]),
                   memory_peak_bytes=torch.cuda.max_memory_allocated()
                   if dev.type == "cuda" else 0)
        if ctx.trace:
            rec.update(spans=spans.seconds, calls=spans.calls, profile=prof,
                       pages_profiled=closed.get("pages_a", 0),
                       flops_per_page=serving.meta_flops(ctx.cell.config, b)
                       / b)
        pred = os.path.join(out_root, "run", "dewarped_pred")
        kept = {bi: dict(v) for bi, v in keeper.kept.items()}
        maps = {k: np.load(os.path.join(pred, f"coord_page_{k:07d}.png.npy"))
                for bi in kept for k in range(bi * b, (bi + 1) * b)}
    finally:
        for n, fn in real.items():
            setattr(driver, n, fn)
        shutil.rmtree(out_root, ignore_errors=True)

    serving.free_program(pipe)
    del pipe
    with serving.reference_precision():
        check = serving.Check(serving.build_reference(ctx.cell.config, seed,
                                                      dev), ctx.controls)
        for bi, got in sorted(kept.items()):
            ks = range(bi * b, (bi + 1) * b)
            src = np.stack([sources[ds.items[k]] for k in ks])
            # run_benchmark's uint8 wire for the 512^2 sources
            src = np.clip(src * 255.0 + 0.5, 0, 255).astype(np.uint8)
            src = torch.from_numpy(src).to(dev).float() / 255.0
            xt = check.ref.draw_xt((xt_seed * 1_000_003 + bi) % (2 ** 63), b)
            flow = torch.stack([torch.from_numpy(maps[k]) for k in ks]).to(dev)
            check.batch(src, xt, flow, conds[bi])
            for j, k in enumerate(ks):
                page = torch.from_numpy(pool[ds.items[k]]).to(dev)
                check.pages(
                    torch.from_numpy(got[k]).float() / 255.0,
                    lambda dt: serving.R.unwarp_page_u8(page, flow[j], dt)
                    .float() / 255.0)
    rec["checks"] = check.result()
    rec["control_checks"] = check.control_result()
    rec["attempted"], rec["failed"] = len(ds.items), 0
    return rec
