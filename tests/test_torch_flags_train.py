"""One train step of the port under each conditioning configuration of the
production DiT against ``dvd_tpu``'s (``tests/test_conditioning_flags.py::
test_train_step_flag_combinations``' parameter sets, plus
``use_init_flow`` and the 'seq' and 'one' cross-attention modes), in
``tests/test_torch_flags.py``'s tiny pipeline: the batch's conditioning
from the frozen nets (the VGG features under ``train_VGG=False``) within
the aux nets' 2e-4 of max|ref|, then the step's loss, gradient norm and
per-sample metrics within 1e-4 (the bars of ``tests/test_torch_train_step
.py``), from the same weights, batch, t and noise, dropout off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from dvd_tpu.training import resample as jresample
from dvd_tpu.training import train_state as jts
from dvd_tpu.training.train_loop import build_device_batch as j_batch
from dvd_tpu.training.train_loop import train_aux_vars
from dvd_tpu_torch.training.train_loop import build_device_batch
from dvd_tpu_torch.training.train_state import (create_train_state,
                                                make_train_step)
from test_torch_common import no_flax_dropout, smooth_field, t
from test_torch_flags import S, SRC, pipelines

FLAGS = [{}, {"use_gt_mask": True}, {"use_line_mask": False},
         {"train_VGG": False}, {"use_init_flow": True},
         {"separate_cross_attn": "seq"}, {"separate_cross_attn": "one"}]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: ",".join(
    f"{k}={v}" for k, v in f.items()) or "shipped")
def test_flag_train_step_matches_dvd_tpu(flags, monkeypatch):
    no_flax_dropout(monkeypatch)
    b = 2
    rng = np.random.RandomState(3)
    raw = {"source_image": rng.rand(b, SRC, SRC, 3).astype(np.float32),
           "doc_mask": np.ones((b, SRC, SRC, 1), np.float32),
           "flow_map": smooth_field(rng, b, SRC, 3.0),
           "flow_map_inter": smooth_field(rng, b, SRC, 2.0)}
    jp, pipe = pipelines(flags, [raw["source_image"]], for_training=True,
                         train=dict(schedule_sampler="uniform", microbatch=-1,
                                    on_device_aug=False))
    for mod in pipe.dit.modules():      # dropout off on the port's side
        if isinstance(getattr(mod, "dropout", None), float):
            mod.dropout = 0.0
    jcfg, cfg = jp.cfg, pipe.cfg

    jb = jax.jit(lambda aux, r: j_batch(jp, aux, r, S))(
        train_aux_vars(jp), {k: jnp.asarray(v) for k, v in raw.items()})
    pb = build_device_batch(pipe, {k: t(v) for k, v in raw.items()}, S)
    assert set(pb) == set(jb), (set(pb), set(jb))
    for k in ("mask_y512", "line_msk", "src_feat"):
        if k in jb:
            want = np.asarray(jb[k])
            err = np.abs(pb[k].permute(0, 2, 3, 1).numpy() - want).max()
            assert err <= 2e-4 * max(1.0, np.abs(want).max()), (k, err)

    sched = j_make_schedule(steps=jcfg.diffusion.diffusion_steps)
    tx = jts.make_optimizer(jcfg)
    jstate = jts.create_train_state(jcfg, jp.dit_vars, tx)
    key = jax.random.PRNGKey(4)
    _, jm = jax.jit(jts.make_train_step(jcfg, sched, jp.dit.apply, tx))(
        jstate, jb, key)
    # the step's draws, rebuilt from its keys (train_state.py:210-260)
    k_t, k_loss = jax.random.split(jax.random.fold_in(key, 0))
    tt, _ = jresample.uniform_sample(k_t, b, sched.num_timesteps)
    k_noise, k_roll = jax.random.split(k_loss)
    noise, roll = (np.asarray(jax.random.normal(k, (b, S, S, 2)))
                   for k in (k_noise, k_roll))

    state = create_train_state(cfg, pipe.dit)
    step = make_train_step(cfg, pipe.sched)
    state, m = step(state, pb, None, t=torch.from_numpy(np.array(tt)),
                    noise=t(noise), rollout_noise=t(roll))
    assert float(jm["grad_norm"]) > 0
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-4)
    for k in ("loss_per_sample", "mse_per_sample", "t"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-4)
