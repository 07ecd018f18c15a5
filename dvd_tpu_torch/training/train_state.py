"""Train state and train step (port of ``dvd_tpu/training/train_state.py``;
reference ``TrainLoop`` internals, ``train_util.py:38-642``).

AdamW (``:111``) after global-norm gradient clipping at 1.0 (``:411``),
with a linear LR anneal over ``lr_anneal_steps`` (``:583-590``), EMA per
rate (``local.py:52``), microbatch gradient accumulation (``:370-375``)
and the timestep samplers of ``training/resample.py``.  One device; the
data-parallel version comes later.

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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dvd_tpu_torch.config import DvDConfig
from dvd_tpu_torch.diffusion import losses as L
from dvd_tpu_torch.diffusion.schedule import DiffusionSchedule
from dvd_tpu_torch.evaluation.pipeline import DTYPES
from dvd_tpu_torch.models.dit import DiT, conditioning_pyramid_features
from dvd_tpu_torch.models.layers import commit_batch_stats
from dvd_tpu_torch.training import resample

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
        norm = global_norm(grads)
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


def make_optimizer(cfg: DvDConfig, params) -> Optimizer:
    return Optimizer(cfg, params)


@dataclasses.dataclass
class TrainState:
    step: int
    model: DiT                  # f32 parameters + SATRN BN running stats
    optimizer: Optimizer
    ema_params: Tuple[Dict[str, torch.Tensor], ...]   # one per EMA rate
    sampler_state: Optional[resample.LossSecondMomentState]

    def named_params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def check_trainable(cfg: DvDConfig) -> None:
    """int8 is a serving path (rounding has no gradient), as in
    ``dvd_tpu``: training under it raises."""
    if cfg.model.quantize != "none":
        raise ValueError(f"model.quantize={cfg.model.quantize!r} cannot be "
                         "trained through; set quantize='none'")


def create_train_state(cfg: DvDConfig, model: DiT) -> TrainState:
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


def make_train_step(cfg: DvDConfig, sched: DiffusionSchedule,
                    spans: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch, generator, *, t=None, noise=None,
    rollout_noise=None) -> (state, metrics)``; the state is updated in
    place.  ``train_step.loss_and_grads`` (same arguments) returns the
    step's gradients before the optimizer, the sampled t and the metrics.

    ``batch`` (device tensors; images NCHW, flows channel-last):
      y512       (B, 3, 512, 512)  source image in [0, 1]
      mask_cat   (B, 1, 512, 512)  document mask
      mask_y512  (B, 384, S, S)    seg pyramid conditioning (if present)
      line_msk   (B, 64, S, S)     text-line conditioning (if present)
      src_feat   (B, 256, S, S)    VGG features (train_VGG=False only)
      flow64     (B, S, S, 2)      GT offsets at latent res
      flow_inter (B, 512, 512, 2)  intermediate offsets
      mask       (B, 512, 512, 1)  loss mask

    ``generator`` (on the batch's device) draws t, the noise, the rollout's
    x_T and the dropout masks; ``t``, ``noise`` (B, S, S, 2) and
    ``rollout_noise`` (B, S, S, 2) pin the first three.  ``spans(name)``,
    when given, is a context manager timing the stages ("rollout",
    "loss_backward", "optimizer_ema")."""
    check_trainable(cfg)
    span = spans or (lambda name: contextlib.nullcontext())
    ema_rates = cfg.train.ema_rates
    s = cfg.model.image_size
    tv = bool(cfg.model.time_variant)
    use_tv = tv and cfg.model.iter
    compute = DTYPES[cfg.model.compute_dtype]

    def autocast(device: torch.device):
        return torch.autocast(device.type, dtype=compute,
                              enabled=compute != torch.float32)

    def loss_fn(dit, batch, t, noise, rollout_noise, generator):
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
                rollout_noise=rollout_noise, generator=generator, span=span)
        return L.composed_warp_loss(*args, init_feat if tv else None, *data,
                                    noise=noise, generator=generator)

    def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator], *,
                       t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       rollout_noise: Optional[torch.Tensor] = None):
        """The step's gradients (one per parameter, scaled by the sampler
        weights and averaged over microbatches) and its metrics; the BN
        running statistics take the step's update, nothing else moves."""
        dit = state.model
        b = batch["flow64"].shape[0]
        dev = batch["flow64"].device
        T = sched.num_timesteps
        st = state.sampler_state
        if t is None:
            t, weights = resample.loss_aware_sample(generator, b, st) \
                if st is not None else \
                resample.uniform_sample(generator, b, T, dev)
        else:
            t = t.to(dev)
            weights = torch.ones((b,), device=dev) if st is None else \
                1.0 / (T * resample.loss_aware_weights(st)[t])

        mb = cfg.train.microbatch
        k = b // mb if 0 < mb < b else 1
        if b % k:
            raise ValueError(f"batch {b} not divisible by microbatch {mb}")
        n = b // k
        params = list(state.named_params().values())
        grads = None
        loss = mse = 0.0
        loss_per, mse_per = [], []
        for i in range(k):
            sl = slice(i * n, (i + 1) * n)
            terms = loss_fn(
                dit, {key: v[sl] for key, v in batch.items()}, t[sl],
                None if noise is None else noise[sl],
                None if rollout_noise is None else rollout_noise[sl],
                generator)
            g = torch.autograd.grad(terms["loss"], params, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi
                 for p, gi in zip(params, g)]
            # the reference's `(loss * weights).mean()` per microbatch
            wm = weights[sl].mean()
            if grads is None:
                grads = torch._foreach_mul(g, wm)
            else:
                torch._foreach_add_(grads, torch._foreach_mul(g, wm))
            lu = terms["loss"].detach()
            loss = loss + lu * wm
            mse = mse + terms["mse"].detach()
            loss_per.append(lu * weights[sl])
            mse_per.append(terms["mse_per"].detach())
        if k > 1:
            torch._foreach_div_(grads, float(k))
        commit_batch_stats(dit)
        metrics = {
            "loss": loss / k,
            "mse": mse / k,
            "t": t.float(),                          # (B,) per sample
            "loss_per_sample": torch.cat(loss_per),  # (B,) weighted
            "mse_per_sample": torch.cat(mse_per),    # (B,) unweighted
        }
        return grads, t, metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], **pins
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("loss_backward"):
            grads, t, metrics = loss_and_grads(state, batch, generator,
                                               **pins)
        with span("optimizer_ema"):
            metrics["grad_norm"] = state.optimizer.step(grads)
            params = list(state.named_params().values())
            with torch.no_grad():
                for rate, ema in zip(ema_rates, state.ema_params):
                    e = list(ema.values())
                    torch._foreach_mul_(e, rate)
                    torch._foreach_add_(e, params, alpha=1.0 - rate)
        if state.sampler_state is not None:
            state.sampler_state = resample.update_history(
                state.sampler_state, t, metrics["mse_per_sample"])
        state.step += 1
        return state, metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step
