"""Train state and train step (port of ``dvd_tpu/training/train_state.py``;
reference ``TrainLoop`` internals, ``train_util.py:38-642``).

AdamW (``:111``) after global-norm gradient clipping at 1.0 (``:411``),
with a linear LR anneal over ``lr_anneal_steps`` (``:583-590``), EMA per
rate (``local.py:52``), microbatch gradient accumulation (``:370-375``)
and the timestep samplers of ``training/resample.py``.  One device, or one
rank of a (data, model) mesh (``parallel/mesh.py``).

How the step follows the JAX one:

- the DiT keeps f32 parameters (``model.param_dtype``) and computes in
  ``model.compute_dtype`` under ``torch.autocast`` (flax ``dtype``);
- every model call of a step runs in train mode (batch-statistics BN,
  dropout), the two rollout calls and the supervised one alike; the BN
  running statistics take one update per step, from the last call
  (``layers.commit_batch_stats``), as JAX keeps the last call's
  ``batch_stats``;
- the DiT's conditioning pyramid is computed once per step with gradient;
  the rollout uses it without gradient, so only the supervised call
  carries its gradient; under ``train_VGG=False`` the batch's frozen VGG
  features (``src_feat``) take its place and the pyramid gets none;
- gradients are scaled by the mean sampler weight before clipping;
  parameters that received no gradient (the dead DiT blocks) get zeros,
  so Adam leaves them unchanged and EMA still runs over them.

Under a mesh the step is ``dvd_tpu``'s one global program, made of
explicit collectives (``torch.autograd.grad`` fires no
``DistributedDataParallel`` or FSDP hook):

- each rank holds its rows of the global batch (``mesh.batch_slice``);
  t (and the sampler weights) are drawn for the global batch from the
  step's generator on every rank and sliced, and the noise, the rollout's
  x_T and the dropout masks are drawn for each global chunk
  (``comm.batch_rows``), so every rank's generator stays where one
  process holding the global batch would have it;
- the loss is the global batch's: each rank's masked squared error over
  the global mask sum, and the gradients are summed over the data group
  (one bucketed ``all_reduce``); train-mode BatchNorm takes the global
  batch's moments (``layers.BatchNorm.group``);
- under microbatching each rank's chunk i is its share of global chunk i,
  so ``train.microbatch``, like ``train.batch_size``, is per process;
- the loss-aware sampler's history takes the global t and the global
  per-sample MSE (an ``all_gather``); the grad norm is computed once over
  the whole tree (``ShardedParams.norm``);
- TP and FSDP (``shard_train_state``): the model holds its TP slices, the
  optimizer and the EMA hold the FSDP shards, gathered back into the model
  after each update.

The alternative denoisers (``train_mode`` ``stage_1``,
``stage_1_transformer``, ``stage_1_doctr``) train through
``losses.plain_masked_mse`` instead (``dvd_tpu``'s ``alt_loss_fn``,
reference train_util.py:350-366): one model call on the batch's VGG
``src_feat`` from a zero ``init_flow``, no rollout, no BN statistics, no
pyramid hoist.  ``sr`` and ``trg_feat`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dvd_tpu_torch.config import DvDConfig
from dvd_tpu_torch.diffusion import losses as L
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule
from dvd_tpu_torch.evaluation.pipeline import DTYPES
from dvd_tpu_torch.models.dit import conditioning_pyramid_features
from dvd_tpu_torch.models.layers import commit_batch_stats
from dvd_tpu_torch.models.registry import check_driver_mode, is_dit_mode
from dvd_tpu_torch.parallel import comm
from dvd_tpu_torch.parallel.mesh import (Mesh, ShardedParams, batch_slice,
                                         gather_batch, shard_params)
from dvd_tpu_torch.training import resample
from dvd_tpu_torch.utils import trace

COND_KEYS = ("y512", "mask_cat", "mask_y512", "line_msk", "src_feat")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (``optax.global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack([n.float() for n in torch._foreach_norm(tensors)]))


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr_schedule,
    weight_decay))`` over a fixed list of parameters.

    Clipping scales by ``max / norm`` only when ``norm >= max`` (optax's
    form, not ``clip_grad_norm_``'s ``max / (norm + 1e-6)``); the schedule
    counts updates from 0; AdamW is torch's with optax's defaults (betas
    0.9/0.999, eps 1e-8) and ``weight_decay`` taken from the config
    (torch's default is 0.01)."""

    def __init__(self, cfg: DvDConfig, params: List[torch.nn.Parameter]):
        self.params = list(params)
        self.norm_fn = global_norm      # the sharded norm under a mesh
        self.max_norm = float(cfg.train.grad_clip)
        self.lr = float(cfg.train.lr)
        self.anneal_steps = int(cfg.train.lr_anneal_steps)
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(cfg.train.weight_decay))

    def learning_rate(self, count: int) -> float:
        if self.anneal_steps:
            # reference _anneal_lr: lr * (1 - step / anneal_steps)
            return self.lr * max(0.0, 1.0 - count / self.anneal_steps)
        return self.lr

    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Clip ``grads`` (one per parameter), apply one AdamW update in
        place; returns the global norm before clipping."""
        norm = self.norm_fn(grads)
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm),
                            self.max_norm / norm)
        for p, g in zip(self.params, torch._foreach_mul(grads, scale)):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.learning_rate(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.adamw.load_state_dict(sd["adamw"])


def microbatch_chunks(cfg: DvDConfig, n: int) -> int:
    """The step's microbatch count for a batch of ``n`` (per process)."""
    mb = cfg.train.microbatch
    return n // mb if 0 < mb < n else 1


def make_optimizer(cfg: DvDConfig, params) -> Optimizer:
    return Optimizer(cfg, params)


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module      # the denoiser: f32 parameters (+ the DiT's
                                # SATRN BN running stats)
    optimizer: Optimizer
    ema_params: Tuple[Dict[str, torch.Tensor], ...]   # one per EMA rate
    sampler_state: Optional[resample.LossSecondMomentState]
    layout: Optional[ShardedParams] = None   # under a mesh

    def named_params(self) -> Dict[str, torch.nn.Parameter]:
        """The model's parameters (under TP its local slices)."""
        return dict(self.model.named_parameters())

    def held_params(self) -> List[torch.Tensor]:
        """What the optimizer and the EMA hold: the parameters, or under
        FSDP their shards."""
        return self.optimizer.params


def check_trainable(cfg: DvDConfig) -> None:
    """int8 is a serving path (rounding has no gradient), as in
    ``dvd_tpu``: training under it raises."""
    if cfg.model.quantize != "none":
        raise ValueError(f"model.quantize={cfg.model.quantize!r} cannot be "
                         "trained through; set quantize='none'")


def create_train_state(cfg: DvDConfig, model: torch.nn.Module
                       ) -> TrainState:
    check_trainable(cfg)
    params = dict(model.named_parameters())
    sampler_state = None
    if cfg.train.schedule_sampler == "loss-second-moment":
        sampler_state = resample.LossSecondMomentState.create(
            cfg.diffusion.diffusion_steps,
            device=next(iter(params.values())).device)
    with torch.no_grad():
        ema = tuple({k: p.detach().clone() for k, p in params.items()}
                    for _ in cfg.train.ema_rates)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, params.values()),
                      ema_params=ema, sampler_state=sampler_state)


@torch.no_grad()
def shard_train_state(cfg: DvDConfig, state: TrainState, mesh: Mesh,
                      fsdp: bool = False) -> TrainState:
    """``state`` (unsharded, e.g. just restored from a checkpoint) laid out
    on ``mesh``: the model TP-sharded in place, the optimizer rebuilt over
    the held tensors with its moments sliced alike, the EMA trees sliced
    (``parallel.mesh.shard_params``, ``ShardedParams``)."""
    placements = shard_params(state.model, mesh, fsdp)
    old = state.optimizer.state_dict()
    layout = ShardedParams(state.model, mesh, placements)
    optimizer = make_optimizer(cfg, layout.held.values())
    names = list(layout.held)
    old["adamw"]["state"] = {
        i: {k: pl.shard(v) if pl is not None and v.dim() else v
            for k, v in st.items()}
        for i, st in old["adamw"]["state"].items()
        for pl in (placements.get(names[i]),)}
    optimizer.load_state_dict(old)
    optimizer.norm_fn = layout.norm
    ema = tuple({n: placements[n].shard(e) if n in placements else e
                 for n, e in tree.items()} for tree in state.ema_params)
    return dataclasses.replace(state, optimizer=optimizer, ema_params=ema,
                               layout=layout)


def make_train_step(cfg: DvDConfig, sched: DiffusionSchedule,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``train_step(state, batch, generator, *, t=None, noise=None,
    rollout_noise=None) -> (state, metrics)``; the state is updated in
    place.  ``train_step.loss_and_grads`` (same arguments) returns the
    step's gradients before the optimizer, the sampled t and the metrics.

    ``batch`` (device tensors; images NCHW, flows channel-last):
      y512       (B, 3, 512, 512)  source image in [0, 1]
      mask_cat   (B, 1, 512, 512)  document mask
      mask_y512  (B, 384, S, S)    seg pyramid conditioning (if present)
      line_msk   (B, 64, S, S)     text-line conditioning (if present)
      src_feat   (B, 256, S, S)    VGG features (train_VGG=False only;
                                   an alternative denoiser's: (B, 64, S, S))
      flow64     (B, S, S, 2)      GT offsets at latent res
      flow_inter (B, 512, 512, 2)  intermediate offsets (the DiT's only)
      mask       (B, 512, 512, 1)  loss mask

    ``generator`` (on the batch's device) draws t, the noise, the rollout's
    x_T and the dropout masks; ``t``, ``noise`` (B, S, S, 2) and
    ``rollout_noise`` (B, S, S, 2) pin the first three.  Under ``mesh``
    (whose layout the state must have, ``shard_train_state``) ``batch`` is
    this rank's rows of the global batch and the pins are the global
    batch's.  The step's stages are spans (``utils/trace.py``):
    ``dvd.train.loss_backward`` (the time-variant loss's rollout inside
    it as ``dvd.train.rollout``) and ``dvd.train.optimizer_ema``."""
    check_trainable(cfg)
    check_driver_mode(cfg.model.train_mode)
    ema_rates = cfg.train.ema_rates
    s = cfg.model.image_size
    tv = bool(cfg.model.time_variant)
    use_tv = tv and cfg.model.iter
    compute = DTYPES[cfg.model.compute_dtype]

    def autocast(device: torch.device):
        return torch.autocast(device.type, dtype=compute,
                              enabled=compute != torch.float32)

    def dit_loss_fn(dit, batch, t, noise, rollout_noise, generator):
        dev = batch["flow64"].device

        def model_fn(x, tt, cond, *, init_flow, init_feat, seed_init_feat,
                     remap_timesteps):
            with autocast(dev):
                return dit(x, tt, init_flow=init_flow, init_feat=init_feat,
                           y512=cond.get("y512"),
                           mask_cat=cond.get("mask_cat"),
                           mask_y512=cond.get("mask_y512"),
                           line_msk=cond.get("line_msk"),
                           src_feat=cond.get("src_feat"),
                           seed_init_feat=seed_init_feat,
                           remap_timesteps=remap_timesteps, train=True,
                           generator=generator)

        cond = {k: batch[k] for k in COND_KEYS if k in batch}
        if "src_feat" not in cond:
            # the pyramid's input is the same for the rollout's calls and
            # the supervised one: compute it once, with gradient
            with autocast(dev):
                cond["src_feat"] = conditioning_pyramid_features(
                    dit.pyramid, batch["y512"], batch.get("mask_cat"), s,
                    dit.dtype)
        b = batch["flow64"].shape[0]
        init_flow = torch.zeros((b, s, s, 2), device=dev)
        init_feat = torch.zeros((b, 256, s, s), device=dev)
        args = (model_fn, sched, cond, init_flow)
        data = (batch["flow64"], batch["flow_inter"], batch["mask"], t)
        if use_tv:
            return L.time_variant_loss(
                *args, init_feat, *data,
                rollout_remap=cfg.model.remap_rollout_timesteps, noise=noise,
                rollout_noise=rollout_noise, generator=generator)
        return L.composed_warp_loss(*args, init_feat if tv else None, *data,
                                    noise=noise, generator=generator)

    def alt_loss_fn(model, batch, t, noise, rollout_noise, generator):
        dev = batch["flow64"].device

        def model_fn(x, tt, cond, *, init_flow):
            with autocast(dev):
                return model(x, tt, src_feat=cond["src_feat"],
                             init_flow=init_flow)

        b = batch["flow64"].shape[0]
        return L.plain_masked_mse(
            model_fn, sched, {"src_feat": batch["src_feat"]},
            batch["flow64"], batch["mask"], t, noise=noise,
            generator=generator,
            init_flow=torch.zeros((b, s, s, 2), device=dev))

    loss_fn = dit_loss_fn if is_dit_mode(cfg.model.train_mode) \
        else alt_loss_fn

    data = mesh.data if mesh is not None else 1
    data_group = mesh.data_group if mesh is not None else None

    def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator], *,
                       t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       rollout_noise: Optional[torch.Tensor] = None):
        """The step's gradients (one per held tensor: summed over the data
        group, scaled by the sampler weights, averaged over microbatches),
        the global batch's t and the metrics (per-sample ones for this
        rank's rows); the BN running statistics take the step's update,
        nothing else moves."""
        dit = state.model
        n = batch["flow64"].shape[0]
        dev = batch["flow64"].device
        T = sched.num_timesteps
        st = state.sampler_state
        b = n * data                                  # the global batch
        if t is None:
            t, weights = resample.loss_aware_sample(generator, b, st) \
                if st is not None else \
                resample.uniform_sample(generator, b, T, dev)
        else:
            t = t.to(dev)
            weights = torch.ones((b,), device=dev) if st is None else \
                1.0 / (T * resample.loss_aware_weights(st)[t])

        k = microbatch_chunks(cfg, n)
        if n % k:
            raise ValueError(f"batch {n} not divisible by microbatch "
                             f"{cfg.train.microbatch}")
        m = n // k
        rows = batch_slice(mesh, n, k).to(dev)
        t_local, w_local = t[rows], weights[rows]
        if noise is not None:
            noise = noise.to(dev)[rows]
        if rollout_noise is not None:
            rollout_noise = rollout_noise.to(dev)[rows]
        chunk_rows = batch_slice(mesh, m)        # this rank's in a chunk
        params = list(state.named_params().values())
        grads = None
        lu, mse_per = [], []
        for i in range(k):
            sl = slice(i * m, (i + 1) * m)
            with comm.batch_rows(chunk_rows, m * data):
                terms = loss_fn(
                    dit, {key: v[sl] for key, v in batch.items()},
                    t_local[sl], None if noise is None else noise[sl],
                    None if rollout_noise is None else rollout_noise[sl],
                    generator)
            # the global chunk's loss: this rank's error over the global
            # mask sum; the ranks' gradients add up to its gradient
            loss = terms["num"] / comm.all_reduce_(terms["den"].clone(),
                                                   data_group)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi
                 for p, gi in zip(params, g)]
            # the reference's `(loss * weights).mean()` per microbatch
            wm = weights[i * m * data:(i + 1) * m * data].mean()
            if grads is None:
                grads = torch._foreach_mul(g, wm)
            else:
                torch._foreach_add_(grads, torch._foreach_mul(g, wm))
            lu.append(loss.detach())
            mse_per.append(terms["mse_per"].detach())
        if k > 1:
            torch._foreach_div_(grads, float(k))
        if state.layout is not None:
            grads = state.layout.reduce_grads(grads)
        commit_batch_stats(dit)
        lu = comm.all_reduce_(torch.stack(lu), data_group)
        wms = weights.reshape(k, m * data).mean(1)
        metrics = {
            "loss": (lu * wms).sum() / k,
            "mse": lu.sum() / k,
            "t": t_local.float(),                    # (n,) per sample
            "loss_per_sample": (lu[:, None] * w_local.reshape(k, m))
            .reshape(n),                             # (n,) weighted
            "mse_per_sample": torch.cat(mse_per),    # (n,) unweighted
        }
        return grads, t, metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], **pins
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with trace.span("dvd.train.loss_backward"):
            grads, t, metrics = loss_and_grads(state, batch, generator,
                                               **pins)
        with trace.span("dvd.train.optimizer_ema"):
            metrics["grad_norm"] = state.optimizer.step(grads)
            held = state.held_params()
            with torch.no_grad():
                for rate, ema in zip(ema_rates, state.ema_params):
                    e = list(ema.values())
                    torch._foreach_mul_(e, rate)
                    torch._foreach_add_(e, held, alpha=1.0 - rate)
            if state.layout is not None:
                state.layout.gather_()
        if state.sampler_state is not None:
            n = batch["flow64"].shape[0]
            state.sampler_state = resample.update_history(
                state.sampler_state, t,
                gather_batch(metrics["mse_per_sample"], mesh,
                             microbatch_chunks(cfg, n)))
        state.step += 1
        return state, metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step
