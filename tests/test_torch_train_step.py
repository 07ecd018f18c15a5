"""The training slice of ``dvd_tpu_torch`` against ``dvd_tpu`` at f32 on the
CPU, in ``tests/test_train_step.py``'s tiny configuration (latent 16,
source 128, a DiT 48 wide and 2 deep): the optimizer, one whole train
step, and the training loop ``train()`` with checkpoint resume.

Both sides of the step get the same weights (through the bridge), the
same batch and the same random draws: t and the noise are rebuilt from
the JAX keys the JAX step splits (``train_state.py:210``,
``losses.py:136``) and handed to the port.  Dropout is off on both sides.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from dvd_tpu.training import resample as jresample
from dvd_tpu.training import train_state as jts
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.diffusion.schedule import make_schedule
from dvd_tpu_torch.training import checkpoint as ckpt
from dvd_tpu_torch.training.convert import variables_to_state_dict
from dvd_tpu_torch.training.train_loop import train
from dvd_tpu_torch.training.train_state import (create_train_state,
                                                make_optimizer,
                                                make_train_step)
from test_torch_common import (S, SRC, TINY_MODEL, assert_trees_close,
                               mini_dit_port, mini_dit_variables,
                               no_flax_dropout, smooth_field, t, torch_named,
                               train_batch)


def _cfgs(**train_over):
    over = dict(model=TINY_MODEL, train=train_over)
    return j_default_config().replace(**over), default_config().replace(**over)


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_matches_optax(weight_decay):
    """Global-norm clip (a step above and a step below the bar) then AdamW
    with a linear LR anneal, on identical gradients."""
    over = dict(lr=1e-2, lr_anneal_steps=4, weight_decay=weight_decay)
    jcfg, cfg = _cfgs(**over)
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    tx = jts.make_optimizer(jcfg)
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(x)) for k, x in params.items()}
    opt = make_optimizer(cfg, tp.values())
    for scale in (3.0, 0.1, 1.0, 0.5):     # global norms above and below 1
        grads = {k: (rng.randn(*x.shape) * scale / 4).astype(np.float32)
                 for k, x in params.items()}
        upd, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([t(grads[k]) for k in tp])
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(
            {k: jnp.asarray(g) for k, g in grads.items()})), rtol=1e-6)
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6)


# ------------------------------------------------------- whole train step
def check_train_step(sampler: str, microbatch: int, monkeypatch) -> None:
    """One ``make_train_step`` step against the JAX step: loss, grad norm,
    per-sample metrics, BN running stats, EMA and (loss-second-moment) the
    sampler history.  With ``microbatch`` > 0 the batch of 4 is two
    accumulated chunks."""
    no_flax_dropout(monkeypatch)
    mod, v = mini_dit_variables()
    b = 4 if microbatch > 0 else 2
    jcfg, cfg = _cfgs(schedule_sampler=sampler, microbatch=microbatch)
    jb, pb = train_batch(b, seed=2)
    tx = jts.make_optimizer(jcfg)
    jstate = jts.create_train_state(jcfg, v, tx)
    jstep = jax.jit(jts.make_train_step(jcfg, j_make_schedule(steps=3),
                                        mod.apply, tx))
    rng = jax.random.PRNGKey(9)
    jstate2, jm = jstep(jstate, jb, rng)

    # the step's draws, rebuilt from its keys (train_state.py:210-260)
    k_t, k_loss = jax.random.split(jax.random.fold_in(rng, 0))
    if sampler == "uniform":
        tt, _ = jresample.uniform_sample(k_t, b, 3)
    else:
        tt, _ = jresample.loss_aware_sample(k_t, b, jstate.sampler_state)
    chunks = [k_loss] if microbatch < 0 else \
        [jax.random.fold_in(k_loss, i) for i in range(b // microbatch)]
    n = b // len(chunks)
    noise, roll = [], []
    for key in chunks:
        k_noise, k_roll = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_noise, (n, S, S, 2))))
        roll.append(np.asarray(jax.random.normal(k_roll, (n, S, S, 2))))

    net = mini_dit_port(v)
    state = create_train_state(cfg, net)
    step = make_train_step(cfg, make_schedule(steps=3))
    state, m = step(state, pb, None, t=torch.from_numpy(np.asarray(tt)),
                    noise=t(np.concatenate(noise)),
                    rollout_noise=t(np.concatenate(roll)))
    assert state.step == int(jstate2.step) == 1
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-4)
    for key in ("loss_per_sample", "mse_per_sample", "t"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=1e-4)
    assert_trees_close(dict(net.named_buffers()),
                       torch_named(jstate2.batch_stats, net, "batch_stats"),
                       rel=1e-5)
    # EMA moves 1e-4 of the way: a gradient sign that differs between the
    # frameworks moves a parameter by ~2 lr, the EMA by ~2e-8
    assert_trees_close(state.ema_params[0],
                       torch_named(jstate2.ema_params[0], net), rel=1e-6)
    if sampler != "uniform":
        js = jstate2.sampler_state
        np.testing.assert_array_equal(state.sampler_state.counts.numpy(),
                                      np.asarray(js.counts))
        np.testing.assert_allclose(state.sampler_state.history.numpy(),
                                   np.asarray(js.history), rtol=1e-4)


def test_train_step_matches_jax(monkeypatch):
    check_train_step("uniform", -1, monkeypatch)


# ------------------------------------------------------- train() + resume
def _wire(seed=0, b=2):
    rng = np.random.RandomState(seed)
    while True:
        yield {"source_image": rng.rand(b, SRC, SRC, 3).astype(np.float32),
               "doc_mask": np.ones((b, SRC, SRC, 1), np.float32),
               "flow_map": smooth_field(rng, b, SRC, 3.0),
               "flow_map_inter": smooth_field(rng, b, SRC, 2.0)}


def _train_cfg(ws):
    return default_config().replace(
        model=dict(TINY_MODEL, dit_variant="DiT-mini"),
        train=dict(on_device_aug=False, log_interval=1, save_interval=1000),
        paths=dict(workspace_dir=str(ws)))


@pytest.fixture(scope="module")
def three_steps(tmp_path_factory):
    ws = tmp_path_factory.mktemp("run3")
    state = train(_train_cfg(ws), _wire(), max_steps=3, device="cpu")
    return ws, state


def test_train_writes_checkpoint_and_ema(three_steps):
    ws, state = three_steps
    run = os.path.join(ws, "default")
    assert state.step == 3
    assert sorted(os.listdir(run)) == ["ema_0.9999_000003.msgpack",
                                       "state_00000003.pt"]
    ema = ckpt.load_variables(os.path.join(run, "ema_0.9999_000003.msgpack"))
    sd, report = variables_to_state_dict(ema, state.model)
    assert report == ([], [], [])
    for k, v in state.model.state_dict().items():
        want = state.ema_params[0].get(k, v)
        assert torch.equal(sd[k], want.cpu()), k
    assert os.path.isfile(os.path.join(ws, "train_default", "progress.csv"))


def test_resume_equals_uninterrupted_run(three_steps, tmp_path):
    """Two steps, a restart that resumes from the checkpoint, one more step:
    bit for bit the three-step run (parameters, optimizer, EMA, BN)."""
    _, want = three_steps
    cfg = _train_cfg(tmp_path)
    train(cfg, _wire(), max_steps=2, device="cpu")
    data = _wire()
    for _ in range(2):
        next(data)               # the batches the first two steps took
    got = train(cfg, data, max_steps=3, device="cpu")
    assert got.step == 3
    for (k, a), b in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(got.ema_params[0].values(), want.ema_params[0].values()):
        assert torch.equal(a, b)
    sa, sb = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 3
    for pa, pb in zip(sa["adamw"]["state"].values(),
                      sb["adamw"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert ckpt.latest_checkpoint(os.path.join(tmp_path, "default")) \
        .endswith("state_00000003.pt")


def _raw_batches(seed=0, b=2):
    """Raw batches for the on-device augmentation: a page in [0, 255], a
    soft mask, a smooth backward-map offset field."""
    rng = np.random.RandomState(seed)
    while True:
        yield {"image512": (rng.rand(b, SRC, SRC, 3) * 255).astype(np.float32),
               "doc_mask512": np.clip(rng.rand(b, SRC, SRC, 1) * 1.5, 0, 1)
               .astype(np.float32),
               "flow_map": smooth_field(rng, b, SRC, 3.0)}


def _aug_cfg(ws, **train_over):
    cfg = _train_cfg(ws)
    return cfg.replace(train=dict(on_device_aug=True, **train_over),
                       data=dict(inter_t=7))


def _assert_same_state(got, want):
    for (k, a), b in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(got.ema_params[0].values(), want.ema_params[0].values()):
        assert torch.equal(a, b)
    sa, sb = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert sa["count"] == sb["count"]
    for pa, pb in zip(sa["adamw"]["state"].values(),
                      sb["adamw"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)


def test_resume_equals_uninterrupted_run_device_aug(tmp_path):
    """The shipped batch kind (raw, augmented on the device, jitter
    factors from (seed, step)): one step, a restart that resumes from the
    checkpoint, one more step: bit for bit the two-step run.  A run from
    other data differs, so the step did use the batches."""
    want = train(_aug_cfg(tmp_path / "a"), _raw_batches(), max_steps=2,
                 device="cpu")
    cfg = _aug_cfg(tmp_path / "b")
    train(cfg, _raw_batches(), max_steps=1, device="cpu")
    data = _raw_batches()
    next(data)                   # the batch the first step took
    got = train(cfg, data, max_steps=2, device="cpu")
    assert got.step == want.step == 2
    _assert_same_state(got, want)
    other = train(_aug_cfg(tmp_path / "c"), _raw_batches(seed=1),
                  max_steps=2, device="cpu")
    assert not all(torch.equal(a, b) for a, b in zip(
        other.model.parameters(), want.model.parameters()))


@pytest.mark.parametrize("on_device_aug", [False, True])
def test_batch_kind_mismatch_warns_once(tmp_path, on_device_aug):
    """A raw batch under ``on_device_aug=False`` is augmented as given, and a
    float-wire batch under ``on_device_aug=True`` used as given: each with
    one warning over two steps, none when the kind agrees."""
    cfg = _aug_cfg(tmp_path, log_interval=1000)
    cfg = cfg.replace(train=dict(on_device_aug=on_device_aug))
    data = _wire() if on_device_aug else _raw_batches()
    with pytest.warns(UserWarning) as record:
        train(cfg, data, max_steps=2, device="cpu")
    msgs = [str(w.message) for w in record if "on_device_aug" in
            str(w.message)]
    assert len(msgs) == 1, msgs
    assert ("raw augmentation keys" in msgs[0]) != on_device_aug
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*on_device_aug")
        train(cfg.replace(paths=dict(workspace_dir=str(tmp_path / "ok"))),
              _raw_batches() if on_device_aug else _wire(), max_steps=1,
              device="cpu")


def test_train_loads_converted_weights(tmp_path, monkeypatch):
    """``train()`` loads the converted weight files at ``cfg.paths`` (flax
    msgpack, written with ``utils/msgpack_io``) before it builds the train
    state, as ``dvd_tpu``: step 0's parameters and EMA are the file's DiT,
    and the frozen nets hold the files' weights, not the seeded ones."""
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training import train_loop
    from dvd_tpu_torch.training.convert import state_dict_to_variables

    cfg = _train_cfg(tmp_path)
    src = DewarpPipeline.create(cfg, "cpu", train=True,
                                generator=torch.Generator().manual_seed(77))
    paths = {}
    for attr, _, field in ckpt.PIPELINE_WEIGHTS:
        paths[field] = str(tmp_path / f"{attr}.msgpack")
        ckpt.save_variables(paths[field], state_dict_to_variables(
            getattr(src, attr).state_dict()))
    cfg = cfg.replace(paths=paths)
    made = []
    create = DewarpPipeline.create

    def recording_create(*args, **kwargs):
        made.append(create(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(train_loop.DewarpPipeline, "create", recording_create)
    state = train(cfg, _wire(), max_steps=0, device="cpu")
    assert state.step == 0 and len(made) == 1
    for k, v in src.dit.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
        if k in state.ema_params[0]:
            assert torch.equal(state.ema_params[0][k], v), k
    seeded = create(cfg, "cpu", train=True,
                    generator=torch.Generator().manual_seed(cfg.train.seed))
    for attr in ("seg", "line", "geotr"):
        got = getattr(made[0], attr).state_dict()
        for k, v in getattr(src, attr).state_dict().items():
            assert torch.equal(got[k], v), (attr, k)
        assert not all(torch.equal(got[k], v) for k, v in
                       getattr(seeded, attr).state_dict().items()), attr
