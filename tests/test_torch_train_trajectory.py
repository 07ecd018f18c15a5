"""Five training steps of ``dvd_tpu_torch`` against five of ``dvd_tpu`` at
f32 on the CPU, in the tiny configuration of ``tests/test_train_step.py``
(latent 16, source 128, perception 64, a DiT 48 wide and 2 deep).

Both loops take the same float-wire batches (built as
``test_torch_train_step.py``'s ``_wire`` builds them) through their own
``build_device_batch`` (the frozen Seg and line UNet with the same weights,
through the bridge), then their own train step; the port's t and noise are
rebuilt from the keys the JAX step splits at each step
(``train_state.py:201``).  Dropout is off on both sides, and U2NetP's soft
mask is held at least 0.05 from the hard 0.5 threshold over every batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from dvd_tpu.evaluation.pipeline import DewarpPipeline as JPipeline
from dvd_tpu.models.dit import DiT as JDiT
from dvd_tpu.models.u2net import U2NetP as JU2NetP
from dvd_tpu.ops.resize import resize_bilinear as j_resize
from dvd_tpu.training import resample as jresample
from dvd_tpu.training import train_state as jts
from dvd_tpu.training.train_loop import build_device_batch as j_build_batch
from dvd_tpu.training.train_loop import train_aux_vars
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.diffusion.schedule import make_schedule
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.training.train_loop import build_device_batch
from dvd_tpu_torch.training.train_state import (create_train_state,
                                                make_train_step)
from test_torch_common import (COND_KEYS, MINI_DIT, S, SRC, TINY_MODEL,
                               assert_trees_close, mask_margin_shift,
                               mini_dit_port, mini_dit_variables, nchw,
                               no_flax_dropout, np_tree, port, smooth_field,
                               torch_named)

STEPS = 5
B = 2
LR = 1e-6


def _wire(seed=0, b=B):
    rng = np.random.RandomState(seed)
    while True:
        yield {"source_image": rng.rand(b, SRC, SRC, 3).astype(np.float32),
               "doc_mask": np.ones((b, SRC, SRC, 1), np.float32),
               "flow_map": smooth_field(rng, b, SRC, 3.0),
               "flow_map_inter": smooth_field(rng, b, SRC, 2.0)}


def _pipelines(raws):
    """(JAX pipeline, port pipeline) with the same random aux weights, the
    soft mask shifted clear of the threshold for every batch."""
    over = dict(model=TINY_MODEL, train=dict(on_device_aug=False, lr=LR))
    jcfg = j_default_config().replace(**over)
    cfg = default_config().replace(**over)
    jp = JPipeline.create(jcfg)
    jp.dit = JDiT(tv=True, chain_blocks=False, **MINI_DIT)   # unused here
    jp.init_params(jax.random.PRNGKey(0))
    seg_vars, line_vars = np_tree(jp.seg_vars), np_tree(jp.line_vars)
    msk = {"params": seg_vars["params"]["msk"],
           "batch_stats": seg_vars["batch_stats"]["msk"]}
    d0 = np.concatenate([np.asarray(JU2NetP(1).apply(msk, j_resize(
        jnp.asarray(r["source_image"]), (64, 64), align_corners=True))[0])
        for r in raws])
    seg_vars["params"]["msk"]["outconv"]["bias"] += mask_margin_shift(d0)
    jp.seg_vars, jp.line_vars = seg_vars, line_vars
    pipe = DewarpPipeline.create(cfg, "cpu", dit=mini_dit_port(
        mini_dit_variables()[1]), train=True)
    port(pipe.seg, seg_vars)
    port(pipe.line, line_vars)
    return jcfg, cfg, jp, pipe


def test_five_train_steps_match_dvd_tpu(monkeypatch):
    """The float-wire batch preparations agree (the aux nets' 2e-4); then
    five train steps of both packages from the same prepared batches, each
    step held to the one-step test's bars: the loss and the gradient norm
    within 1e-4, the EMA within 1e-6, the BN statistics within 1e-5.  Then
    each parameter's displacement over the five steps, elementwise, within
    10 f32 ulps of the parameter plus 5% of lr a step: AdamW moves an
    element by about lr a step, so a wrong moment, bias correction or clip
    shows as a large fraction of lr, while the ratio m/sqrt(v) carries the
    gradients' own f32 rounding from step to step (measured: up to 3% of
    lr over the five steps).  Only an element whose gradient came within twice the one-step
    test's gradient bar of zero (1e-3 x max(1, max|g|)) may have taken the
    other sign there, and from that step on it is allowed 3 lr a step.

    At lr 1e-6 rather than the shipped 1e-4.  AdamW's first updates are lr
    times the sign of the gradient, so a gradient at rounding level (the
    small ones move with rounding, see
    ``test_torch_train_models.py:test_losses_and_gradients``) that takes
    the other sign moves its parameter by 2 lr, and the time-variant loss
    (rollout, clamps, warps) amplifies that from step to step.  At lr 1e-4
    ``dvd_tpu``'s own trajectory from its parameters moved by one f32 ulp
    moves the grad norm by up to 3e-1 and the loss by up to 8e-2 within
    five steps (``tests/torch_trajectory_spread.py``), so no bar could
    tell a fault from rounding there.  At lr 1e-6 the flipped updates stay
    below the bars, and every part of the loop still runs: the optimizer's
    moments and bias corrections, the clipping, the EMA, the BN statistics
    and the per-step draws."""
    no_flax_dropout(monkeypatch)
    data = _wire()
    raws = [next(data) for _ in range(STEPS)]
    jcfg, cfg, jp, pipe = _pipelines(raws)
    jprep = jax.jit(lambda aux, raw: j_build_batch(jp, aux, raw, S))
    batches = []
    for raw in raws:
        jb = jprep(train_aux_vars(jp),
                   {k: jnp.asarray(a) for k, a in raw.items()})
        pb = build_device_batch(
            pipe, {k: torch.from_numpy(a) for k, a in raw.items()}, S)
        for k, a in jb.items():
            got = pb[k].permute(0, 2, 3, 1) if k in COND_KEYS else pb[k]
            np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=2e-4,
                                       rtol=1e-4, err_msg=k)
        batches.append(jb)

    mod, v = mini_dit_variables()
    tx = jts.make_optimizer(jcfg)
    jstep = jax.jit(jts.make_train_step(jcfg, j_make_schedule(steps=3),
                                        mod.apply, tx))
    jstate = jts.create_train_state(jcfg, v, tx)
    net = mini_dit_port(v)
    state = create_train_state(cfg, net)
    step = make_train_step(cfg, make_schedule(steps=3))
    start = {k: p.detach().numpy().copy() for k, p in net.named_parameters()}
    # per element, the first step whose gradient may have taken the other
    # sign (STEPS if none did)
    first_flip = {k: np.full(p.shape, STEPS) for k, p in start.items()}
    apply_update = state.optimizer.step

    def recorded_step(grads):
        tau = 2e-3 * max(1.0, max(g.abs().max().item() for g in grads))
        for (k, ff), g in zip(first_flip.items(), grads):
            np.minimum(ff, np.where(g.abs().numpy() <= tau, state.step,
                                    STEPS), out=ff)
        return apply_update(grads)

    state.optimizer.step = recorded_step
    rng = jax.random.PRNGKey(9)
    losses = []
    for s, jb in enumerate(batches):
        jstate, jm = jstep(jstate, jb, rng)
        # the step's draws, from the keys the JAX step splits
        k_t, k_loss = jax.random.split(jax.random.fold_in(rng, s))
        tt, _ = jresample.uniform_sample(k_t, B, 3)
        k_noise, k_roll = jax.random.split(k_loss)
        noise = np.array(jax.random.normal(k_noise, (B, S, S, 2)))
        roll = np.array(jax.random.normal(k_roll, (B, S, S, 2)))
        batch = {k: nchw(a) if k in COND_KEYS else torch.from_numpy(
            np.array(a)) for k, a in jb.items()}
        state, m = step(state, batch, None, t=torch.from_numpy(np.array(tt)),
                        noise=torch.from_numpy(noise),
                        rollout_noise=torch.from_numpy(roll))
        assert state.step == int(jstate.step) == s + 1
        losses.append(float(jm["loss"]))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"step {s} {key}")
        assert_trees_close(state.ema_params[0],
                           torch_named(jstate.ema_params[0], net), rel=1e-6)
        assert_trees_close(dict(net.named_buffers()), torch_named(
            jstate.batch_stats, net, "batch_stats"), rel=1e-5)
    assert len({round(x, 6) for x in losses}) == STEPS   # the batches differ
    got = dict(net.named_parameters())
    for k, w in torch_named(jstate.params, net).items():
        p = got[k].detach().numpy()
        err = np.abs((p - start[k]) - (w - start[k]))
        bar = 10 * np.spacing(np.maximum(np.abs(p), np.abs(start[k]))) \
            + 0.05 * LR * STEPS + 3 * LR * (STEPS - first_flip[k])
        assert (err <= bar).all(), \
            f"{k}: {int((err > bar).sum())} elements, worst {err.max():.3e}"
