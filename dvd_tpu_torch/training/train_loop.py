"""The training loop: data -> conditioning (frozen aux nets) -> train step ->
checkpoints and metrics (port of ``dvd_tpu/training/train_loop.py``;
reference ``TrainLoop.run_loop_dewarping``, ``train_util.py:211-344``).

- the frozen Seg + line-UNet conditioning is computed on the device per
  batch, without gradient, through K2 (``:275-293``), and under
  ``train_VGG=False`` the frozen VGG16 features that replace the DiT's
  pyramid (``:296-304``); ``use_init_flow`` changes nothing in training,
  as in ``dvd_tpu`` (the step starts from a zero ``init_flow``);
- GT flows are normalised by ``size - 1`` and the latent target resized to
  64^2 (``:306-312``);
- logging every ``log_interval`` with per-quartile loss keys, checkpoints
  every ``save_interval`` (``:333-339``);
- one device, or one rank of the (``parallel.data_axis``,
  ``parallel.model_axis``) mesh over an initialised ``torch.distributed``
  group, with ``parallel.fsdp`` (``parallel/mesh.py``): each rank feeds its
  rows of the global batch (``train.batch_size`` per process), the
  augmentation's jitter factors are drawn for the global batch and
  sliced, rank 0 writes the logs and checkpoints.

Batches are channel-last numpy arrays or tensors of one of two kinds,
told apart by their keys, as in ``dvd_tpu``:

- the on-device augmentation's raw batch (``train.on_device_aug``, the
  shipped default): ``image512`` (B, 512, 512, 3) in [0, 255],
  ``doc_mask512`` (B, 512, 512, 1), ``flow_map`` (B, 512, 512, 2)
  absolute offsets; ``data/device_aug.augment_batch`` warps and jitters
  it on the device, with jitter factors drawn from (``train.seed``, step);
- the float wire, augmented on the host: ``source_image`` in [0, 1],
  ``doc_mask``, ``flow_map`` and ``flow_map_inter``.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from dvd_tpu_torch.config import DvDConfig
from dvd_tpu_torch.data.device_aug import augment_batch, jitter_factors
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.models.u2net import seg_pyramid_to_latent
from dvd_tpu_torch.models.vgg import c20_for_dit, c20_for_unet
from dvd_tpu_torch.ops.resize import resize_bilinear
from dvd_tpu_torch.parallel import comm
from dvd_tpu_torch.parallel.mesh import Mesh, batch_slice, make_mesh
from dvd_tpu_torch.training import checkpoint as ckpt
from dvd_tpu_torch.training.train_state import (TrainState, create_train_state,
                                                make_train_step,
                                                microbatch_chunks,
                                                shard_train_state)
from dvd_tpu_torch.utils import trace
from dvd_tpu_torch.utils.logger import KVLogger, log_loss_quartiles

def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def build_device_batch(pipe: DewarpPipeline, raw: Dict[str, torch.Tensor],
                       latent: int) -> Dict[str, torch.Tensor]:
    """Float-wire batch (device tensors) -> the train step's batch:
    conditioning (NCHW) and normalised flow targets (channel-last).

    Streams follow the reference's flags (``train_util.py:275-304``): with
    ``use_gt_mask`` neither the seg pyramid nor the line stream is made;
    the line stream also needs ``use_line_mask``; ``train_VGG=False`` adds
    the VGG features as ``src_feat`` (f32, from the f32 source).  An
    alternative denoiser takes the VGG's 64-ch ``c20_for_unet`` plane as
    its ``src_feat`` and no other stream."""
    m = pipe.cfg.model
    src = raw["source_image"]
    if src.dtype == torch.uint8:
        src = src.float() / 255.0
    mask_cat = raw["doc_mask"]
    if mask_cat.dtype == torch.uint8:
        mask_cat = mask_cat.float() / 255.0
    src, mask_cat = src.float(), mask_cat.float()
    h = src.shape[1]
    flow_inter = raw["flow_map_inter"].float() / (h - 1.0)
    flow = raw["flow_map"].float() / (h - 1.0)
    if flow.shape[1] != latent:
        flow = resize_bilinear(_nchw(flow), (latent, latent), True) \
            .permute(0, 2, 3, 1)
    y512 = _nchw(src)
    batch = {
        "y512": y512,
        "mask_cat": _nchw(mask_cat),
        "flow64": flow.contiguous(),
        "flow_inter": flow_inter.contiguous(),
        "mask": torch.ones((src.shape[0], h, h, 1), device=src.device),
    }
    if not pipe.is_dit:
        batch["src_feat"] = c20_for_unet(pipe.vgg(y512), latent)
        return batch
    if not m.use_gt_mask:
        per = m.perception_size
        xa = resize_bilinear(y512, (per, per), True).to(pipe.dtype)
        mskx, _, pyramid = pipe.seg(xa.contiguous())
        batch["mask_y512"] = seg_pyramid_to_latent(pyramid, latent)
        if m.use_line_mask:
            line_feat, _ = pipe.line(mskx)
            batch["line_msk"] = resize_bilinear(line_feat, (latent, latent),
                                                False)
    if pipe.vgg is not None:
        batch["src_feat"] = c20_for_dit(pipe.vgg(y512), latent)
    return batch


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator (t, noise, rollout x_T, dropout), seeded from
    (seed, step) alone, as JAX folds the step into its key: a resumed run
    draws what the uninterrupted run would have."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (2 ** 63))


def make_batch_prep(cfg: DvDConfig, pipe: DewarpPipeline
                    ) -> Callable[[Dict, int], Dict[str, torch.Tensor]]:
    """``prep(raw, step)``: a host or device batch of either kind (see the
    module docstring) -> the train step's batch on ``pipe.device``.

    A raw batch goes through ``augment_batch`` at ``data.inter_t /
    data.inter_T`` with jitter factors drawn from a generator seeded by
    (``train.seed ^ 0x5EED``, step), so a resumed run draws what the
    uninterrupted run would have.  A batch whose kind disagrees with
    ``train.on_device_aug`` is used as it is, with one warning."""
    device, latent = pipe.device, cfg.model.image_size
    frac = cfg.data.inter_t / cfg.data.inter_T
    warned = []

    def warn_once(msg):
        if not warned:
            warnings.warn(msg, stacklevel=3)
            warned.append(True)

    @torch.no_grad()
    def prep(raw: Dict, step: int) -> Dict[str, torch.Tensor]:
        raw = {k: torch.as_tensor(v).to(device, non_blocking=True)
               for k, v in raw.items()}
        if "image512" in raw:
            if not cfg.train.on_device_aug:
                warn_once("train.on_device_aug=False but the batch carries "
                          "the raw augmentation keys (image512, ...); "
                          "augmenting it on the device as given")
            gen = step_generator(cfg.train.seed ^ 0x5EED, step, device)
            raw = augment_batch(raw, jitter_factors(raw["image512"].shape[0],
                                                    gen),
                                inter_frac=frac)
        elif cfg.train.on_device_aug:
            warn_once("train.on_device_aug=True but the batch carries the "
                      "pre-augmented float-wire keys; using it as given")
        return build_device_batch(pipe, raw, latent)

    return prep


def put_global_batch(raw: Dict, device) -> Dict[str, torch.Tensor]:
    """This process's rows of the global batch (host arrays or tensors) ->
    tensors on ``device``: each rank holds its own part and the step's
    collectives make it one global batch (``dvd_tpu`` assembles a global
    array from every process's part)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in raw.items()}


def fetch_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host values of a step's metrics: the global scalars, and this rank's
    per-sample values (its rows), as ``dvd_tpu`` fetches each process's
    addressable shards; the logger then reduces across ranks."""
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()}


def train(cfg: DvDConfig, data_iter: Iterator[Dict],
          max_steps: Optional[int] = None, device="cuda",
          logger: Optional[KVLogger] = None,
          mesh: Optional[Mesh] = None) -> TrainState:
    """Train the denoiser on ``data_iter``'s batches until it ends or
    ``max_steps`` steps are done; returns the final state (also saved to
    ``workspace_dir/name``).  Weights are drawn from ``train.seed``, then
    the converted weight files found at ``cfg.paths`` are loaded over them
    (the DiT's too, before the train state is built from it), as in
    ``dvd_tpu``; a checkpoint in the workspace (or
    ``train.resume_checkpoint``) wins over the loaded DiT.  Each step's
    batch preparation, the augmentation included, is the span
    ``dvd.train.prep`` (``utils/trace.py``; the step's own spans: see
    ``make_train_step``).

    ``mesh`` (default ``make_mesh(parallel.data_axis,
    parallel.model_axis)``, which asserts that the layout covers the
    ranks) lays the state out under an initialised process group or
    ``parallel.fsdp``; the returned state is then sharded as it trained.
    Each rank's ``data_iter`` yields its rows of the global batch; ranks
    of one model group must yield the same batches."""
    device = torch.device(device)
    ws = os.path.join(cfg.paths.workspace_dir, cfg.name)
    if mesh is None:
        mesh = make_mesh(cfg.parallel.data_axis, cfg.parallel.model_axis)
    if logger is None:
        logger = KVLogger(
            os.path.join(cfg.paths.workspace_dir, f"train_{cfg.name}")
            if mesh.primary else None,
            formats=("stdout", "csv", "jsonl") if mesh.primary else ())
    pipe = DewarpPipeline.create(
        cfg, device, generator=torch.Generator().manual_seed(cfg.train.seed),
        train=True)
    loaded = ckpt.maybe_load_pipeline_weights(pipe, cfg)
    logger.log(f"converted weights loaded: {loaded}")
    state = create_train_state(cfg, pipe.dit)
    resume = cfg.train.resume_checkpoint or ckpt.latest_checkpoint(ws)
    if resume and os.path.isfile(str(resume)):
        state = ckpt.restore_train_state(resume, state)
        logger.log(f"resumed from {resume} at step {state.step}")
    sharded = dist.is_initialized() or cfg.parallel.fsdp
    if sharded:
        state = shard_train_state(cfg, state, mesh, cfg.parallel.fsdp)
        logger.log(f"mesh {mesh.shape}, fsdp={cfg.parallel.fsdp}: "
                   f"{len(state.layout.placements)} parameters sharded")
    train_step = make_train_step(cfg, pipe.sched, mesh if sharded else None)
    prep = make_batch_prep(cfg, pipe)

    step = state.step
    t_last = time.perf_counter()
    for raw in data_iter:
        if max_steps is not None and step >= max_steps:
            break
        raw = put_global_batch(raw, device)
        n = next(iter(raw.values())).shape[0]
        rows = batch_slice(mesh, n, microbatch_chunks(cfg, n))
        with trace.span("dvd.train.prep"), \
                comm.batch_rows(rows, n * mesh.data):
            batch = prep(raw, step)
        gen = step_generator(cfg.train.seed, step, device)
        state, metrics = train_step(state, batch, gen)

        if step % cfg.train.log_interval == 0:
            m = fetch_metrics(metrics)
            log_loss_quartiles(logger, pipe.sched.num_timesteps, m.pop("t"),
                               {"loss": m.pop("loss_per_sample"),
                                "mse": m.pop("mse_per_sample")})
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            logger.logkv("step", step)
            logger.logkv("grad_norm", float(m["grad_norm"]))
            logger.logkv("samples_per_sec", n * mesh.data
                         * cfg.train.log_interval / max(dt, 1e-9))
            logger.dumpkvs(step)

        if step > 0 and step % cfg.train.save_interval == 0:
            logger.log(f"saved {ckpt.save_train_state(ws, state)}")
            ckpt.save_ema_snapshots(ws, cfg, state, step)
        step += 1

    ckpt.save_train_state(ws, state)
    ckpt.save_ema_snapshots(ws, cfg, state, state.step)
    return state
