"""How far five f32 train steps at the shipped lr part, port against
``dvd_tpu`` and ``dvd_tpu`` against itself from parameters moved by one
f32 ulp, on the CPU in the tiny configuration of
``test_torch_train_trajectory.py`` (the reason that test runs at lr 1e-6).

    JAX_PLATFORMS=cpu python tests/torch_trajectory_spread.py

Prints, per step, the relative difference of the loss and of the
gradient norm: the port's from ``dvd_tpu``'s, then ``dvd_tpu``'s own
from two one-ulp moves of its starting parameters.  Not a test (no
assertion); a few minutes.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parent)]
import test_torch_train_trajectory as T  # noqa: E402
from dvd_tpu.diffusion.schedule import make_schedule as j_make_schedule  # noqa: E402
from dvd_tpu.training import resample as jresample  # noqa: E402
from dvd_tpu.training import train_state as jts  # noqa: E402
from dvd_tpu.training.train_loop import build_device_batch as j_build_batch  # noqa: E402
from dvd_tpu.training.train_loop import train_aux_vars  # noqa: E402
from dvd_tpu_torch.diffusion.schedule import make_schedule  # noqa: E402
from dvd_tpu_torch.training.train_state import (create_train_state,  # noqa: E402
                                                make_train_step)
from test_torch_common import (COND_KEYS, mini_dit_port,  # noqa: E402
                               mini_dit_variables, nchw)

LR = 1e-4   # the shipped rate


def main():
    import flax.linen as fnn

    fnn.Dropout.__call__ = lambda self, x, *a, **k: x   # dropout off
    T.LR = LR
    data = T._wire()
    raws = [next(data) for _ in range(T.STEPS)]
    jcfg, cfg, jp, pipe = T._pipelines(raws)
    jprep = jax.jit(lambda aux, raw: j_build_batch(jp, aux, raw, T.S))
    batches = [jprep(train_aux_vars(jp),
                     {k: jnp.asarray(a) for k, a in raw.items()})
               for raw in raws]
    mod, v = mini_dit_variables()
    tx = jts.make_optimizer(jcfg)
    jstep = jax.jit(jts.make_train_step(jcfg, j_make_schedule(steps=3),
                                        mod.apply, tx))
    rng = jax.random.PRNGKey(9)

    def jax_run(variables):
        state, out = jts.create_train_state(jcfg, variables, tx), []
        for b in batches:
            state, m = jstep(state, b, rng)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    def moved(seed):
        r = np.random.RandomState(seed)
        return {"params": jax.tree_util.tree_map(
            lambda a: (np.float32(a) * (1 + r.choice([-1.0, 1.0], np.shape(a))
                                        * 2.0 ** -23)).astype(np.float32),
            v["params"]), "batch_stats": v["batch_stats"]}

    net = mini_dit_port(v)
    state = create_train_state(cfg, net)
    step = make_train_step(cfg, make_schedule(steps=3))
    port = []
    for s, jb in enumerate(batches):
        k_t, k_loss = jax.random.split(jax.random.fold_in(rng, s))
        tt, _ = jresample.uniform_sample(k_t, T.B, 3)
        k_noise, k_roll = jax.random.split(k_loss)
        batch = {k: nchw(a) if k in COND_KEYS else torch.from_numpy(
            np.array(a)) for k, a in jb.items()}
        state, m = step(state, batch, None, t=torch.from_numpy(np.array(tt)),
                        noise=torch.from_numpy(np.array(jax.random.normal(
                            k_noise, (T.B, T.S, T.S, 2)))),
                        rollout_noise=torch.from_numpy(np.array(
                            jax.random.normal(k_roll, (T.B, T.S, T.S, 2)))))
        port.append((m["loss"].item(), m["grad_norm"].item()))
    want = jax_run(v)
    rel = lambda a, b: [(abs(x[0] / y[0] - 1), abs(x[1] / y[1] - 1))
                        for x, y in zip(a, b)]
    print("lr", LR, "per step (loss, grad norm) relative to dvd_tpu's:")
    print("  port:", [(f"{a:.2e}", f"{b:.2e}") for a, b in rel(port, want)])
    for seed in (1, 2):
        print(f"  dvd_tpu moved one ulp (seed {seed}):",
              [(f"{a:.2e}", f"{b:.2e}") for a, b in rel(jax_run(moved(seed)),
                                                        want)])


if __name__ == "__main__":
    main()
