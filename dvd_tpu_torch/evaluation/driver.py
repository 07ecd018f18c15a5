"""Batched benchmark driver (DocUNet-130 / DIR300 / AnyPhotoDoc6300 /
DocReal) on one card; port of ``dvd_tpu/evaluation/driver.py``.

Replaces the reference's bs=1 per-image loop (``evaluation.py:142-327``)
with device batches:

- pages stream in fixed-size batches padded into one canvas (one
  ``unwarp_native`` call serves every original size), decoded by a
  background thread;
- uint8 crosses to the card in both directions: the 512^2 sources and the
  canvases go up as uint8 and become f32 on the card, the unwarped
  canvases come back as uint8 (round half to even, clip, cast);
- the loader thread makes a batch's inputs into host tensors (on a card
  in pinned host memory); on a card the copies neither block the host nor
  idle the compute stream: the inputs go up on a stream of their own while
  the previous batch computes, and the results come back on another into
  pinned memory as soon as the batch's unwarp is done;
- one batch stays in flight: batch i is dispatched before batch i-1's
  results are handed to the writers, and PNGs and coordinate maps are
  written by a thread pool, at most ``WRITE_BACKLOG`` batches behind,
  under the reference's naming
  ``vis_hp/{dataset}/{name}/dewarped_pred/warped_*.png``
  (``visualization_utils.py:64-91``), so downstream metric tooling is
  drop-in compatible.

``run_stats.json`` has ``dvd_tpu``'s keys: ``imgs_per_sec`` excludes the
first batch (which pays the kernel build and the first launches), and
``stage_seconds_per_batch`` comes from synchronised re-runs of the last
batch, outside the throughput window.

Over a (data, model) mesh of ``torch.distributed`` ranks
(``parallel/mesh.py``) each data index dewarps its rows of every global
batch (x_T drawn for the global batch from the batch's generator and
sliced, ``parallel.comm.batch_rows``), and the model axis shards the DiT
and its SATRN decoder by the tensor-parallel rules (the aux nets stay
whole, as in ``dvd_tpu``'s driver); a page's outputs are written by the
rank of model index 0 that holds it, and rank 0 writes ``run_stats.json``
with the image count summed over the data group.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from dvd_tpu_torch.config import DvDConfig
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.ops.kernels.unwarp import unwarp
from dvd_tpu_torch.parallel import comm
from dvd_tpu_torch.parallel.mesh import batch_slice, make_mesh, shard_params
from dvd_tpu_torch.utils import trace

# the fields of a line of ``spans.jsonl`` (a record of ``utils/trace.py``)
SPAN_KEYS = ("i", "name", "t0_ns", "t1_ns", "thread", "parent", "attrs")
# drained batches whose writes may still run: a drain first waits for the
# writes of older ones, so writers slower than the loop hold at most this
# many batches' results (on a card, their pinned blocks)
WRITE_BACKLOG = 2


def save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path)


def prefetched_batches(dataset, batch_size: int, depth: int = 2):
    """Yield ``dataset.batches(batch_size)`` items produced by a background
    thread (decode and padding overlap device work).  A producer's
    exception (an unreadable image) is re-raised here, so a dead producer
    cannot hang the consumer.  Spans: ``dvd.loader.batch`` around each
    batch made (the loader thread), ``dvd.driver.wait`` around each wait
    for one (the caller's thread)."""
    batch_q: "queue.Queue" = queue.Queue(maxsize=depth)

    def _producer():
        try:
            batches = iter(dataset.batches(batch_size))
            for bi in itertools.count():
                with trace.span("dvd.loader.batch", batch=bi):
                    item = next(batches, None)
                if item is None:
                    break
                batch_q.put(item)
            batch_q.put(None)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            batch_q.put(e)

    threading.Thread(target=_producer, daemon=True).start()
    while True:
        with trace.span("dvd.driver.wait"):
            item = batch_q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


class _Staged:
    """``dataset`` whose batches carry ``staged``, ``stage(batch)``, made
    by the thread that iterates it: so ``prefetched_batches``' loader
    thread stages batches, and ``prefetched_batches`` keeps its
    signature."""

    def __init__(self, dataset, stage):
        self.dataset, self.stage = dataset, stage

    def batches(self, batch_size: int):
        for batch in self.dataset.batches(batch_size):
            yield dict(batch, staged=self.stage(batch))


@torch.inference_mode()
def unwarp_u8(padded: torch.Tensor, hw: torch.Tensor,
              flow: torch.Tensor) -> torch.Tensor:
    """``unwarp_native`` -> uint8: round half to even (as ``jnp.round``),
    clip to [0, 255], cast; on a card inside the fused unwarp's one
    launch."""
    return unwarp(padded, flow, hw, out_u8=True)


def _write(fn, path: str, arr: np.ndarray) -> None:
    """``fn(path, arr)`` in a ``dvd.driver.write`` span (a writer thread)."""
    with trace.span("dvd.driver.write"):
        fn(path, arr)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_generator(device: torch.device, seed: int,
                    bi: int) -> torch.Generator:
    """The x_T generator of batch ``bi``, seeded from (seed, bi) alone, as
    ``dvd_tpu`` folds the batch index into its key."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + bi) % (2 ** 63))


def serving_mesh(pipe: DewarpPipeline, mesh="auto"):
    """The mesh ``run_benchmark`` serves on: ``mesh`` itself, or for
    "auto" ``make_mesh(parallel.data_axis, parallel.model_axis)`` under an
    initialised process group or a model axis > 1 (``make_mesh`` asserts
    that the layout covers the ranks), else None (one process, unsharded).
    A model axis > 1 TP-shards ``pipe.dit`` in place, once."""
    par = pipe.cfg.parallel
    if mesh == "auto":
        mesh = make_mesh(par.data_axis, par.model_axis) \
            if dist.is_initialized() or par.model_axis != 1 else None
    if mesh is not None and mesh.model > 1 \
            and getattr(pipe.dit, "tp_mesh", None) is None:
        shard_params(pipe.dit, mesh)
        pipe.dit.tp_mesh = mesh
    return mesh


@torch.inference_mode()
def run_benchmark(pipe: DewarpPipeline, dataset, out_dir: str, *,
                  batch_size: int = 8, seed: int = 0,
                  save_outputs: bool = True, save_coord_maps: bool = False,
                  profile_dir: Optional[str] = None,
                  mesh="auto") -> Dict[str, float]:
    """Dewarp every page of ``dataset`` (``__len__`` and ``batches``, as
    :class:`~dvd_tpu_torch.data.benchmark.BenchmarkDataset`) on the
    pipeline's device, write the outputs under ``out_dir/dewarped_pred``
    and ``out_dir/run_stats.json``, and return the stats.
    ``profile_dir``: a ``torch.profiler`` trace of the steady state (every
    batch after the first, the profiler started before the throughput
    clock) is written there as ``trace.json``, and beside it
    ``spans.jsonl``: the program's spans (``utils/trace.py``) of every
    thread recorded while the profiler ran, one JSON object a line
    (``i``, ``name``, ``t0_ns``, ``t1_ns``, ``thread``, ``parent``,
    ``attrs``), stamped in Unix-epoch nanoseconds, the clock of the
    profiler's host events.  The loop's body is covered by spans:
    ``dvd.driver.wait``, ``dvd.driver.h2d`` (the batch's inputs onto the
    device), ``dvd.cond``, ``dvd.sample``, ``dvd.unwarp`` and
    ``dvd.driver.drain`` (the previous batch's results to the host and
    its writes queued, each write a ``dvd.driver.write`` span in a writer
    thread; on a card, where the pull into pinned memory began after the
    batch's unwarp, its ``ready`` says whether that pull was done when
    the drain began; the CPU's drain has no ``ready``).  ``mesh``: see
    :func:`serving_mesh`; ``batch_size`` is the global batch, which must
    divide over its data axis.  ``parallel.fsdp`` shards training state:
    serving holds whole weights, as ``dvd_tpu``'s driver does."""
    dev = pipe.device
    mesh = serving_mesh(pipe, mesh)
    data = mesh.data if mesh is not None else 1
    if batch_size % data:
        raise ValueError(f"batch {batch_size} does not divide over the "
                         f"mesh's data axis {data}")
    rows = batch_slice(mesh, batch_size // data)
    rows_np = rows.numpy()

    def local(a):               # this rank's rows of a host batch array
        return a if data == 1 else np.asarray(a)[rows_np]

    writes = mesh is None or mesh.model_index == 0
    primary = mesh is None or mesh.primary
    pred_dir = os.path.join(out_dir, "dewarped_pred")
    os.makedirs(pred_dir, exist_ok=True)

    def dewarp(src, gen):
        with comm.batch_rows(rows, batch_size):
            cond, init_flow, init_feat = pipe.build_conditioning(src)
            return pipe.sampling_impl(cond, init_flow, init_feat, gen)

    card = dev.type == "cuda"
    if card:
        compute = torch.cuda.current_stream(dev)
        up_stream, pull_stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def stage(batch):
        """This rank's rows of a batch's inputs as host tensors, made in
        the loader thread (on the main thread this work held up the
        launches): the 512^2 sources as uint8, the canvases, their pages'
        sizes.  On a card they are copied into pinned memory (PyTorch's
        caching host allocator hands a block out again only once the copy
        that last read it is done)."""
        src = np.asarray(local(batch["source_image"]))
        ts = [torch.from_numpy(a) for a in (
            np.clip(src * 255.0 + 0.5, 0, 255).astype(np.uint8),
            local(batch["source_padded"]), local(batch["hw"]))]
        return [t.pin_memory() for t in ts] if card else ts

    def upload(ts):
        """Host tensors onto the device.  On a card they are copied on the
        upload stream, which the compute stream then waits for: neither the
        host nor the batch in flight waits for the copy."""
        if not card:
            return [t.to(dev) for t in ts]
        with torch.cuda.stream(up_stream):
            ts = [t.to(dev, non_blocking=True) for t in ts]
        compute.wait_stream(up_stream)
        for t in ts:                # made on the upload stream, read here
            t.record_stream(compute)
        return ts

    def pull(out, flow):
        """On a card, send a batch's uint8 pages and f32 flows to the host
        once the compute stream has made them: copied on the pull stream
        into pinned memory while the next batch computes.  Returns the host
        tensors and the event of their copy; None on the CPU, where
        ``drain`` copies."""
        if not card:
            return None
        flow = flow.float()
        pull_stream.wait_stream(compute)
        with torch.cuda.stream(pull_stream):
            host = []
            for t in (out, flow):
                t.record_stream(pull_stream)
                host.append(torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                            .copy_(t, non_blocking=True))
            done = torch.cuda.Event()
            done.record()
        return host[0], host[1], done

    writer = ThreadPoolExecutor(max_workers=4)
    queued = deque()                # each drained batch's write futures
    n_done = 0

    def wait_writes(keep):
        """Wait for the writes of all but the newest ``keep`` drained
        batches (a writer's error surfaces here)."""
        while len(queued) > keep:
            for fut in queued.popleft():
                fut.result()

    def drain(inflight):
        """Hand one batch's results to the writers, once those of all but
        the newest ``WRITE_BACKLOG - 1`` drained batches are written: on a
        card the pinned copies of its pull, once done (a writer's numpy
        view keeps its block alive), with ``ready`` on the span: whether
        the pull was done when the drain began; on the CPU a copy made
        here."""
        nonlocal n_done
        out_dev, flow_dev, pulled, batch, bi = inflight
        attrs = {} if pulled is None else {"ready": pulled[2].query()}
        with trace.span("dvd.driver.drain", batch=bi, **attrs):
            wait_writes(WRITE_BACKLOG - 1)
            futs = []
            queued.append(futs)
            if pulled is None:
                out = out_dev.cpu().numpy()
                flow_np = flow_dev.float().cpu().numpy()
            else:
                out_host, flow_host, done = pulled
                done.synchronize()
                out, flow_np = out_host.numpy(), flow_host.numpy()
            for j, g in enumerate(rows_np.tolist()):
                if g >= batch["count"]:          # the last batch's padding
                    continue
                n_done += 1
                if not writes:
                    continue
                name = os.path.basename(batch["paths"][g])
                h, w = batch["hw"][g]
                if save_outputs:
                    futs.append(writer.submit(
                        _write, save_png,
                        os.path.join(pred_dir, f"warped_{name}"),
                        out[j, :h, :w]))
                if save_coord_maps:
                    futs.append(writer.submit(
                        _write, np.save,
                        os.path.join(pred_dir, f"coord_{name}.npy"),
                        flow_np[j]))

    prof, first_span = None, 0
    compile_time, t_start = 0.0, None
    inflight, last_inputs = None, None
    try:
        for bi, batch in enumerate(prefetched_batches(
                _Staged(dataset, stage), batch_size)):
            # this rank's uint8 sources and canvases
            nbytes = (np.size(batch["source_image"]) + np.asarray(
                batch["source_padded"]).nbytes) * len(rows_np) // batch_size
            with trace.span("dvd.driver.h2d", batch=bi, bytes=nbytes):
                src_u8, padded, hw = upload(batch["staged"])
                src = src_u8.to(torch.float32) / 255.0
                gen = batch_generator(dev, seed, bi)
            t0 = time.perf_counter()
            flow = dewarp(src, gen)
            out = unwarp_u8(padded, hw, flow)
            if bi == 0:
                _sync(dev)
                # the first batch pays the kernel build and the first
                # launches: excluded from the throughput
                compile_time = time.perf_counter() - t0
                if profile_dir and primary:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                    prof = profile(activities=acts)
                    first_span = len(trace.records())
                    # the profiler's start takes seconds: before the clock
                    prof.__enter__()
                t_start = time.perf_counter()
            pulled = pull(out, flow)
            if inflight is not None:
                drain(inflight)
            inflight = (out, flow, pulled, batch, bi)
            last_inputs = (src, padded, hw, bi)
        if inflight is not None:
            drain(inflight)
        wait_writes(0)              # surface writer errors before reporting
    finally:
        writer.shutdown()
        if prof is not None:
            prof.__exit__(None, None, None)
    _sync(dev)
    t_end = time.perf_counter()
    if mesh is not None:
        count = torch.tensor([n_done], dtype=torch.float64, device=dev)
        n_done = int(comm.all_reduce_(count, mesh.data_group).item())
    if prof is not None:            # the dump is not part of the throughput
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        spans = os.path.join(profile_dir, "spans.jsonl")
        with open(spans, "w") as f:
            for i, r in enumerate(trace.records()[first_span:], first_span):
                f.write(json.dumps(dict(zip(SPAN_KEYS, (i,) + r))) + "\n")
        print(f"profiler trace written to {path}, program spans to {spans}")

    if n_done > batch_size:
        total = t_end - (t_start or t_end)
        n_timed = n_done - batch_size
    else:                           # one batch: it is all there is
        total = compile_time
        n_timed = n_done
    stats = {
        "images": n_done,
        "seconds_total": round(total, 3),
        "imgs_per_sec": round(n_timed / total, 3) if total > 0 else 0.0,
        "compile_seconds": round(compile_time, 3),
    }
    if n_done:
        src, padded, hw, bi = last_inputs
        stage = {}
        for name, fn in (
                ("conditioning", lambda: pipe.build_conditioning(src)),
                ("sample", lambda: dewarp(src, batch_generator(dev, seed, bi))),
                ("unwarp", lambda: unwarp_u8(padded, hw, flow))):
            fn()                    # warm
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            stage[name] = round(time.perf_counter() - t0, 4)
        stage["sample"] = round(
            max(stage["sample"] - stage["conditioning"], 0.0), 4)
        stats["stage_seconds_per_batch"] = stage
    if primary:
        with open(os.path.join(out_dir, "run_stats.json"), "w") as f:
            json.dump(stats, f, indent=2)
    return stats


def run_from_config(cfg: DvDConfig, seed: int = 0, device="cuda",
                    profile_dir: Optional[str] = None) -> Dict[str, float]:
    """CLI-facing entry: the pipeline (weights drawn from
    ``cfg.train.seed``, then any converted files at ``cfg.paths``) and the
    dataset at ``cfg.data.eval_dataset``, on ``device`` (the card unless
    the caller asks for the CPU), batch ``data.eval_device_batch`` per
    data index (scaled by the mesh's data axis, which is the world size
    at ``model_axis`` 1, as ``dvd_tpu`` scales it by its device count);
    outputs under ``vis_hp/{eval_dataset_name}/{cfg.name}``."""
    from dvd_tpu_torch.data.benchmark import BenchmarkDataset
    from dvd_tpu_torch.training.checkpoint import maybe_load_pipeline_weights

    pipe = DewarpPipeline.create(
        cfg, device, generator=torch.Generator().manual_seed(cfg.train.seed))
    loaded = maybe_load_pipeline_weights(pipe, cfg)
    print(f"loaded weights: {loaded}")
    ds = BenchmarkDataset.from_dir(cfg.data.eval_dataset,
                                   source_size=cfg.model.source_size)
    out_dir = os.path.join("vis_hp", cfg.data.eval_dataset_name, cfg.name)
    mesh = serving_mesh(pipe, "auto")
    batch = cfg.data.eval_device_batch * (mesh.data if mesh else 1)
    return run_benchmark(pipe, ds, out_dir, batch_size=batch, seed=seed,
                         profile_dir=profile_dir, mesh=mesh)
