"""Training the alternative denoisers in the port against ``dvd_tpu`` at f32
on the CPU, in ``tests/test_alt_denoisers.py``'s tiny configuration
(latent 16, width 32, one ResBlock a level, 2 heads, attention at "8,4",
``train_VGG=False``): ``plain_masked_mse`` and one whole train step per
drivable family (``dvd_tpu``'s ``alt_loss_fn``: one model call from a zero
init_flow, no rollout).

Both sides of the step get the same weights (through the bridge), the
same batch and the same draws: t and the noise are rebuilt from the keys
the JAX step splits (``train_state.py:210``; ``plain_masked_mse`` draws
its noise from the loss key itself).  Bars: the loss and the gradient
norm within 1e-4 relative, every gradient within 1e-4 x max(1e-2,
max|g|) of its own tensor, the EMA after the step within 1e-6 of
max(1, max|p|).  The CLI's two-step run is in
``tests/test_torch_alt_train_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu.diffusion import losses as JL
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from dvd_tpu.models import registry as jreg
from dvd_tpu.training import resample as jresample
from dvd_tpu.training import train_state as jts
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.diffusion import losses as L
from dvd_tpu_torch.diffusion.schedule import make_schedule
from dvd_tpu_torch.models import registry
from dvd_tpu_torch.training.train_state import (create_train_state,
                                                make_train_step)
from test_torch_common import (assert_trees_close, nchw, port,
                               random_variables, smooth_field, t, torch_named)

S, H = 16, 64
ALT = dict(image_size=S, source_size=128, perception_size=64,
           compute_dtype="float32", train_VGG=False, num_channels=32,
           num_res_blocks=1, num_heads=2, attention_resolutions="8,4")


def test_plain_masked_mse():
    """The loss itself on a fixed smooth model of (x_t, t): the rescaled
    timesteps reach the model, a partial mask, the bilinear resize to the
    mask's size."""
    rng = np.random.RandomState(0)
    b = 3
    x0 = smooth_field(rng, b, S, 0.1)
    mask = (rng.rand(b, H, H) > 0.3).astype(np.float32)
    tt = np.array([0, 1, 2])
    noise = rng.randn(b, S, S, 2).astype(np.float32)
    w = rng.randn(2, 2).astype(np.float32)

    def j_model(x, tm, cond, **kw):
        return jnp.tanh(x @ jnp.asarray(w)) * (tm[:, None, None, None] / 1e3) \
            + kw["init_flow"]

    def p_model(x, tm, cond, **kw):
        return torch.tanh(x @ t(w)) * (tm[:, None, None, None] / 1e3) \
            + kw["init_flow"]

    # dvd_tpu draws its noise from the key it is given
    key = jax.random.PRNGKey(4)
    jnoise = np.asarray(jax.random.normal(key, (b, S, S, 2)))
    init = 0.01 * noise
    want = JL.plain_masked_mse(j_model, j_make_schedule(steps=3), {},
                               jnp.asarray(x0), jnp.asarray(mask),
                               jnp.asarray(tt), key,
                               init_flow=jnp.asarray(init))
    got = L.plain_masked_mse(p_model, make_schedule(steps=3), {}, t(x0),
                             t(mask), torch.from_numpy(tt), noise=t(jnoise),
                             init_flow=t(init))
    for k in ("mse", "loss", "mse_per"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5)


def _batch(b, seed):
    rng = np.random.RandomState(seed)
    jb = {"flow64": smooth_field(rng, b, S, 0.1),
          "mask": (rng.rand(b, H, H, 1) > 0.2).astype(np.float32),
          "src_feat": (0.3 * rng.randn(b, S, S, 64)).astype(np.float32)}
    pb = {k: nchw(v) if k == "src_feat" else t(v) for k, v in jb.items()}
    return {k: jnp.asarray(v) for k, v in jb.items()}, pb


@pytest.mark.parametrize("mode", ["stage_1", "stage_1_transformer",
                                  "stage_1_doctr"])
def test_alt_train_step_matches_jax(mode):
    over = dict(model=dict(ALT, train_mode=mode))
    jcfg = j_default_config().replace(**over)
    cfg = default_config().replace(**over)
    b = 2
    jb, pb = _batch(b, seed=3)
    jm = jreg.create_model(jcfg)
    z = jnp.zeros
    v = random_variables(jm, z((1, S, S, 2)), z((1,)),
                         src_feat=z((1, S, S, 64)), init_flow=z((1, S, S, 2)),
                         seed=5)
    jsched = j_make_schedule(steps=3)
    tx = jts.make_optimizer(jcfg)
    jstate = jts.create_train_state(jcfg, v, tx)
    rng = jax.random.PRNGKey(9)
    jstate2, jm_metrics = jax.jit(jts.make_train_step(
        jcfg, jsched, jm.apply, tx))(jstate, jb, rng)
    # the step's draws (train_state.py:210; losses.py:171)
    k_t, k_loss = jax.random.split(jax.random.fold_in(rng, 0))
    tt, _ = jresample.uniform_sample(k_t, b, 3)
    noise = np.asarray(jax.random.normal(k_loss, (b, S, S, 2)))

    def j_loss(params):
        def model_fn(x, tm, cond, **kw):
            out = jm.apply({"params": params}, x, tm,
                           src_feat=cond["src_feat"],
                           init_flow=kw["init_flow"])
            return out[0] if isinstance(out, tuple) else out

        return JL.plain_masked_mse(
            model_fn, jsched, {"src_feat": jb["src_feat"]}, jb["flow64"],
            jb["mask"], tt, k_loss, init_flow=z((b, S, S, 2)))["loss"]

    jgrads = jax.jit(jax.grad(j_loss))(jstate.params)

    net = port(registry.create_model(cfg), v)
    state = create_train_state(cfg, net)
    step = make_train_step(cfg, make_schedule(steps=3))
    pins = dict(t=torch.from_numpy(np.asarray(tt)), noise=t(noise))
    grads, _, _ = step.loss_and_grads(state, pb, None, **pins)
    want = torch_named(jgrads, net)
    assert_trees_close(dict(zip(state.named_params(), grads)), want,
                       rel=1e-4, floor=1e-2)
    assert sum(float(np.abs(g).max()) > 0 for g in want.values()) \
        >= 0.9 * len(want)          # the gradient reaches (almost) all
    state, m = step(state, pb, None, **pins)
    np.testing.assert_allclose(m["loss"].item(), float(jm_metrics["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm_metrics["grad_norm"]), rtol=1e-4)
    for key in ("loss_per_sample", "mse_per_sample", "t"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm_metrics[key]),
                                   rtol=1e-4)
    assert_trees_close(state.ema_params[0],
                       torch_named(jstate2.ema_params[0], net), rel=1e-6)
