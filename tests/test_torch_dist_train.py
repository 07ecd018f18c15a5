"""The port's data-parallel train step (``parallel/mesh.py``,
``training/train_state.py``) in 2-process gloo worlds on the CPU, against
the port's single-process step on the global batch and against
``dvd_tpu``'s single-process step on its 8-device mesh
(``tests/multihost_common.py``'s set-up: the same global batch, the DiT 48
wide, 2 deep, no time variance), within ``tests/test_multihost.py``'s 1e-5
on the loss and 1e-4 x max|g| on every gradient.  Also the logger's
cross-rank means, the loader's rank striding, ``run_training
--multihost`` under ``torch.distributed.run``, and the repairs: the
parallel layout is honoured or refused, the model factory defaults to the
card.

Both sides get the same weights (random, no zero leaf: a zero-initialised
final layer would leave the gradients nothing to carry), the same t and
noise (rebuilt from the JAX step's keys); dropout is off.
"""

import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from dvd_tpu.training import resample as jresample
from dvd_tpu.training import train_state as jts
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.diffusion.schedule import make_schedule
from dvd_tpu_torch.models.dit import DiT
from dvd_tpu_torch.training.train_state import (create_train_state,
                                                make_train_step)
from multihost_common import B, S, SRC, global_batch
from test_torch_common import (COND_KEYS, assert_trees_close, nchw,
                               no_flax_dropout, port, random_variables,
                               recorded_step, run_world, t, torch_named,
                               train_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"image_size": S, "source_size": SRC, "perception_size": 64,
         "compute_dtype": "float32", "time_variant": False, "iter": False}
DIT = dict(input_size=S, patch_size=2, in_channels=2, hidden_size=48,
           depth=2, num_heads=3, tv=False, chain_blocks=False)


def _variables(seed=5):
    from dvd_tpu.models.dit import DiT as JDiT

    mod = JDiT(**DIT)
    z = jax.numpy.zeros
    return mod, random_variables(
        mod, z((1, S, S, 2)), z((1,)), y512=z((1, SRC, SRC, 3)),
        mask_cat=z((1, SRC, SRC, 1)), mask_y512=z((1, S, S, 384)),
        line_msk=z((1, S, S, 64)), init_flow=z((1, S, S, 2)), seed=seed)


def _port_batch(jb):
    return {k: nchw(v) if k in COND_KEYS else t(v) for k, v in jb.items()}


def _single(cfg, variables, pb, dtype=torch.float32, **pins):
    net = port(DiT(dropout=0.0, **DIT), variables).to(dtype)
    state = create_train_state(cfg, net)
    step = make_train_step(cfg, make_schedule(steps=3))
    pb = {k: v.to(dtype) for k, v in pb.items()}
    pins = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in pins.items()}
    state, m, grads = recorded_step(step, state, pb, **pins)
    return net, state, m, {k: g.numpy() for k, g in grads.items()}


@pytest.fixture(scope="module")
def dp_vs_dvd_tpu(tmp_path_factory):
    """dvd_tpu's step on its 8-device mesh, the port's single-process step
    and the port's data=2 world, on multihost_common's global batch."""
    from dvd_tpu.parallel.mesh import make_mesh as j_make_mesh
    from dvd_tpu.training.train_loop import put_global_batch as j_put

    mod, v = _variables()
    jcfg = j_default_config().replace(model=MODEL)
    tx = jts.make_optimizer(jcfg)
    jstate = jts.create_train_state(jcfg, v, tx)
    step = jax.jit(jts.make_train_step(jcfg, j_make_schedule(steps=3),
                                       mod.apply, tx))
    jb = global_batch()
    rng = jax.random.PRNGKey(0)
    mesh = j_make_mesh(data=-1, model=1)
    assert mesh.shape == {"data": 8, "model": 1}
    with mesh, pytest.MonkeyPatch.context() as mp:
        no_flax_dropout(mp)
        jstate2, jm = step(jstate, j_put(jb, NamedSharding(mesh, P("data"))),
                           rng)
        jm = jax.device_get(jm)
    k_t, k_loss = jax.random.split(jax.random.fold_in(rng, 0))
    tt, _ = jresample.uniform_sample(k_t, B, 3)
    noise = np.array(jax.random.normal(k_loss, (B, S, S, 2)))

    cfg = default_config().replace(model=MODEL)
    pins = {"t": torch.from_numpy(np.array(tt)), "noise": t(noise)}
    pb = _port_batch(jb)
    net, _, m1, _ = _single(cfg, v, pb, **pins)
    fresh = port(DiT(dropout=0.0, **DIT), v)
    world = run_world("step", dict(
        cfg={"model": MODEL}, dit=dict(DIT), state_dict=fresh.state_dict(),
        batch=pb, mesh=(2, 1), **pins), tmp_path_factory.mktemp("dp"))
    return (jstate2, jm, net), m1, world


def test_dp_step_matches_dvd_tpu_8_devices(dp_vs_dvd_tpu):
    """In f32: the loss within 1e-5 of dvd_tpu's (and of the port's single
    process), the grad norm, the per-sample metrics, the BN running
    statistics (the global batch's moments) and the EMA."""
    (jstate2, jm, net), m1, w = dp_vs_dvd_tpu
    assert w["rows"].tolist() == [0, 1, 2, 3]    # rank 0's: the first half
    assert abs(w["loss"] - float(jm["loss"])) < 1e-5
    assert abs(w["loss"] - m1["loss"].item()) < 1e-5
    np.testing.assert_allclose(w["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-4)
    for key in ("t", "loss_per_sample", "mse_per_sample"):
        np.testing.assert_allclose(w[key].numpy(), np.asarray(jm[key]),
                                   rtol=1e-4)
    assert_trees_close({k: v for k, v in w["state"].items()
                        if k.endswith((".mean", ".var"))},
                       torch_named(jstate2.batch_stats, net, "batch_stats"),
                       rel=1e-5)
    assert_trees_close(w["ema"], torch_named(jstate2.ema_params[0], net),
                       rel=1e-6)


def test_multihost_weighted_means(dp_vs_dvd_tpu):
    """Disjoint key sets on the two ranks: count-weighted over both; one
    process: the local means."""
    from dvd_tpu_torch.utils.logger import multihost_weighted_means

    *_, w = dp_vs_dvd_tpu
    assert w["means"] == pytest.approx({"loss_q0": 1.0, "loss_q2": 3.0,
                                        "shared": 2.0})
    assert multihost_weighted_means({"a": (6.0, 3), "b": (1.0, 2)}) == \
        {"a": 2.0, "b": 0.5}


@pytest.mark.parametrize("microbatch", [-1, 1])
def test_dp_step_matches_single_process(microbatch, tmp_path):
    """A data=2 step against the single-process step on the global batch
    of 4, whose halves have different statistics (the second scaled up, so
    BN moments taken per rank would move the loss far beyond the bar),
    under the loss-aware sampler (its history from the global t and MSE):
    plain, and at microbatch 1 per rank (each rank's chunk i its share of
    global chunk i) against microbatch 2.  In float64 on both sides: in
    f32 the decoder's BN (flax's E[x^2] - E[x]^2 variance, then a ReLU)
    turns rounding into kinks, and the f32 single-process gradients are
    themselves up to 4% off float64 there."""
    _, v = _variables(seed=6)
    _, pb = train_batch(4, seed=3)
    for k in ("y512", "mask_y512", "line_msk"):
        pb[k][2:] *= 3.0
    rng = np.random.RandomState(4)
    pins = {"t": torch.from_numpy(rng.randint(0, 3, 4)),
            "noise": t(rng.randn(4, S, S, 2).astype(np.float32))}
    model = dict(MODEL, source_size=128)
    sampler = "loss-second-moment"
    cfg = default_config().replace(
        model=model, train={"microbatch": 2 * microbatch,
                            "schedule_sampler": sampler})
    _, state1, m1, g1 = _single(cfg, v, pb, torch.float64, **pins)
    fresh = port(DiT(dropout=0.0, **DIT), v)
    w = run_world("step", dict(
        cfg={"model": model, "train": {"microbatch": microbatch,
                                       "schedule_sampler": sampler}},
        dit=dict(DIT), state_dict=fresh.state_dict(), batch=pb,
        mesh=(2, 1), dtype=torch.float64, **pins), tmp_path)
    assert w["rows"].tolist() == ([0, 1] if microbatch < 0 else [0, 2])
    assert abs(w["loss"] - m1["loss"].item()) < 1e-5
    assert_trees_close(w["grads"], g1, rel=1e-4, floor=1e-12)
    np.testing.assert_allclose(w["history"].numpy(),
                               state1.sampler_state.history.numpy(),
                               rtol=1e-6)
    assert_trees_close({k: x for k, x in w["state"].items()
                        if k.endswith((".mean", ".var"))},
                       {k: x.numpy() for k, x in
                        state1.model.state_dict().items()
                        if k.endswith((".mean", ".var"))}, rel=1e-6)


def test_loader_striding_matches_dvd_tpu():
    """Each rank's batches: the PrefetchLoader of ``dvd_tpu`` at the same
    process index and count, item for item."""
    from dvd_tpu.data.loader import PrefetchLoader as JLoader
    from dvd_tpu_torch.data.loader import PrefetchLoader

    class DS:
        def __len__(self):
            return 12

        def __getitem__(self, i, seed=0):
            return {"x": np.full((2,), i, np.float32)}

    for pi in range(2):
        kw = dict(batch_size=2, num_workers=1, seed=7, shuffle=True,
                  process_index=pi, process_count=2)
        got, want = iter(PrefetchLoader(DS(), **kw)), iter(JLoader(DS(),
                                                                  **kw))
        for _ in range(5):                    # across an epoch boundary
            np.testing.assert_array_equal(next(got)["x"], next(want)["x"])


def test_run_training_multihost(tmp_path):
    """``run_training --multihost --synthetic 3 --device cpu`` as two
    ranks of ``torch.distributed.run``: the two training pages, one per
    rank, through the host loader (no device-resident set under two
    processes); rank 0 writes the checkpoint, the EMA snapshot and the
    logs."""
    sets = ["model.dit_variant='DiT-mini'", "model.image_size=16",
            "model.source_size=128", "model.perception_size=64",
            "model.compute_dtype='float32'", "train.batch_size=1",
            f"paths.workspace_dir='{tmp_path / 'ws'}'",
            f"data.data_root='{tmp_path / 'data'}'", "data.n_threads=1"]
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_port",
           str(test_torch_common.free_port()),
           "-m", "dvd_tpu_torch.cli.run_training", "--multihost",
           "--synthetic", "3", "--max_steps", "2", "--device", "cpu"]
    for kv in sets:
        cmd += ["--set", kv]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ,
                                                OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "device-resident dataset" not in proc.stdout
    assert "mesh {'data': 2, 'model': 1}" in proc.stdout
    run = tmp_path / "ws" / "default"
    assert sorted(os.listdir(run)) == ["ema_0.9999_000002.msgpack",
                                       "state_00000002.pt"]
    assert (tmp_path / "ws" / "train_default" / "progress.csv").is_file()
    blob = torch.load(run / "state_00000002.pt", weights_only=True)
    assert blob["step"] == 2


def test_train_honours_or_refuses_the_layout(tmp_path):
    """``parallel.model_axis=2`` in one process: refused by the mesh, as
    ``dvd_tpu``'s ``make_mesh`` refuses it (the parent trained unsharded
    and said nothing); ``parallel.fsdp`` in one process: the optimizer and
    the EMA hold the shards (here of one rank: whole)."""
    from dvd_tpu_torch.training.train_loop import train
    from test_torch_common import TINY_MODEL

    def cfg(**par):
        return default_config().replace(
            model=dict(TINY_MODEL, dit_variant="DiT-mini"),
            train=dict(on_device_aug=False, save_interval=1000),
            parallel=par, paths=dict(workspace_dir=str(tmp_path)))

    with pytest.raises(AssertionError, match="not divisible by model=2"):
        train(cfg(model_axis=2), iter(()), max_steps=0, device="cpu")
    state = train(cfg(fsdp=True), iter(()), max_steps=0, device="cpu")
    assert state.layout is not None and state.layout.fsdp
    held = dict(zip(state.layout.held, state.held_params()))
    name = "decoder.layer_stack_0.attn.linear_q.weight"
    assert held[name] is not state.named_params()[name]


def test_create_model_and_diffusion_defaults_to_the_card():
    from dvd_tpu_torch.models.registry import create_model_and_diffusion

    assert inspect.signature(create_model_and_diffusion) \
        .parameters["device"].default == "cuda"
