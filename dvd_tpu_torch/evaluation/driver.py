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
- one batch stays in flight: batch i is dispatched before batch i-1's
  results are pulled back, and PNGs and coordinate maps are written by a
  thread pool under the reference's naming
  ``vis_hp/{dataset}/{name}/dewarped_pred/warped_*.png``
  (``visualization_utils.py:64-91``), so downstream metric tooling is
  drop-in compatible.

``run_stats.json`` has ``dvd_tpu``'s keys: ``imgs_per_sec`` excludes the
first batch (which pays the kernel build and the first launches), and
``stage_seconds_per_batch`` comes from synchronised re-runs of the last
batch, outside the throughput window.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from dvd_tpu_torch.config import DvDConfig
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_native


def save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path)


def prefetched_batches(dataset, batch_size: int, depth: int = 2):
    """Yield ``dataset.batches(batch_size)`` items produced by a background
    thread (decode and padding overlap device work).  A producer's
    exception (an unreadable image) is re-raised here, so a dead producer
    cannot hang the consumer."""
    batch_q: "queue.Queue" = queue.Queue(maxsize=depth)

    def _producer():
        try:
            for item in dataset.batches(batch_size):
                batch_q.put(item)
            batch_q.put(None)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            batch_q.put(e)

    threading.Thread(target=_producer, daemon=True).start()
    while True:
        item = batch_q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


@torch.inference_mode()
def unwarp_u8(padded: torch.Tensor, hw: torch.Tensor,
              flow: torch.Tensor) -> torch.Tensor:
    """``unwarp_native`` -> uint8: round half to even (as ``jnp.round``),
    clip to [0, 255], cast."""
    out = unwarp_native(padded, hw, flow)
    return torch.round(out).clamp_(0.0, 255.0).to(torch.uint8)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_generator(device: torch.device, seed: int,
                    bi: int) -> torch.Generator:
    """The x_T generator of batch ``bi``, seeded from (seed, bi) alone, as
    ``dvd_tpu`` folds the batch index into its key."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + bi) % (2 ** 63))


@torch.inference_mode()
def run_benchmark(pipe: DewarpPipeline, dataset, out_dir: str, *,
                  batch_size: int = 8, seed: int = 0,
                  save_outputs: bool = True, save_coord_maps: bool = False,
                  profile_dir: Optional[str] = None) -> Dict[str, float]:
    """Dewarp every page of ``dataset`` (``__len__`` and ``batches``, as
    :class:`~dvd_tpu_torch.data.benchmark.BenchmarkDataset`) on the
    pipeline's device, write the outputs under ``out_dir/dewarped_pred``
    and ``out_dir/run_stats.json``, and return the stats.
    ``profile_dir``: a ``torch.profiler`` trace of the steady state (every
    batch after the first) is written there."""
    dev = pipe.device
    pred_dir = os.path.join(out_dir, "dewarped_pred")
    os.makedirs(pred_dir, exist_ok=True)

    def dewarp(src, gen):
        cond, init_flow, init_feat = pipe.build_conditioning(src)
        return pipe.sampling_impl(cond, init_flow, init_feat, gen)

    writer = ThreadPoolExecutor(max_workers=4)
    pending = []
    n_done = 0

    def drain(inflight):
        """Pull one batch's results to the host and queue the writes."""
        nonlocal n_done
        out_dev, flow_dev, batch = inflight
        out = out_dev.cpu().numpy()
        flow_np = flow_dev.float().cpu().numpy()
        for j in range(batch["count"]):
            name = os.path.basename(batch["paths"][j])
            h, w = batch["hw"][j]
            if save_outputs:
                pending.append(writer.submit(
                    save_png, os.path.join(pred_dir, f"warped_{name}"),
                    out[j, :h, :w]))
            if save_coord_maps:
                pending.append(writer.submit(
                    np.save, os.path.join(pred_dir, f"coord_{name}.npy"),
                    flow_np[j]))
        n_done += batch["count"]

    prof = None
    compile_time, t_start = 0.0, None
    inflight, last_inputs = None, None
    try:
        for bi, batch in enumerate(prefetched_batches(dataset, batch_size)):
            src_u8 = torch.from_numpy(np.clip(
                np.asarray(batch["source_image"]) * 255.0 + 0.5, 0, 255
            ).astype(np.uint8)).to(dev)
            src = src_u8.to(torch.float32) / 255.0
            padded = torch.from_numpy(batch["source_padded"]).to(dev)
            hw = torch.from_numpy(batch["hw"]).to(dev)
            gen = batch_generator(dev, seed, bi)
            t0 = time.perf_counter()
            flow = dewarp(src, gen)
            out = unwarp_u8(padded, hw, flow)
            if bi == 0:
                _sync(dev)
                # the first batch pays the kernel build and the first
                # launches: excluded from the throughput
                compile_time = time.perf_counter() - t0
                t_start = time.perf_counter()
                if profile_dir:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                    prof = profile(activities=acts)
                    prof.__enter__()
            if inflight is not None:
                drain(inflight)
            inflight = (out, flow, batch)
            last_inputs = (src, padded, hw, bi)
        if inflight is not None:
            drain(inflight)
        for fut in pending:         # surface writer errors before reporting
            fut.result()
    finally:
        writer.shutdown()
        if prof is not None:
            prof.__exit__(None, None, None)
    _sync(dev)
    t_end = time.perf_counter()
    if prof is not None:            # the dump is not part of the throughput
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")

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
    with open(os.path.join(out_dir, "run_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    return stats


def run_from_config(cfg: DvDConfig, seed: int = 0, device="cuda",
                    profile_dir: Optional[str] = None) -> Dict[str, float]:
    """CLI-facing entry: the pipeline (weights drawn from
    ``cfg.train.seed``, then any converted files at ``cfg.paths``) and the
    dataset at ``cfg.data.eval_dataset``, on ``device`` (the card unless
    the caller asks for the CPU), batch ``data.eval_device_batch``;
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
    return run_benchmark(pipe, ds, out_dir,
                         batch_size=cfg.data.eval_device_batch, seed=seed,
                         profile_dir=profile_dir)
