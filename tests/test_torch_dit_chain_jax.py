"""The port's chained 'para' DiT against ``dvd_tpu``'s at DiT-mini (the
flax variables carried across by the weight bridge), and the served
``dewarp_flow`` with ``chain_blocks=True`` at the tiny serving size
against the benchmark's plain chained reference's DDIM loop, on one state
drawn by ``perfbench.weights.draw_state``; f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.models import dit as jdit
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.models import dit
from perfbench import pages, weights
from perfbench.reference import dit_chain
from test_torch_common import (MINI_DIT, S, SRC, fill_zero_leaves, nchw,
                               np_tree, port, t)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(2, S, S, 2).astype(np.float32),
        t=np.array([1000 * 2 / 3, 1000 / 3], np.float32),
        y512=rng.rand(2, SRC, SRC, 3).astype(np.float32),
        mask_cat=rng.rand(2, SRC, SRC, 1).astype(np.float32),
        mask_y512=rng.randn(2, S, S, 384).astype(np.float32),
        line_msk=rng.randn(2, S, S, 64).astype(np.float32),
        init_flow=(rng.randn(2, S, S, 2) * 0.1).astype(np.float32),
        init_feat=rng.randn(2, S, S, 256).astype(np.float32))


def test_chained_dit_matches_flax():
    mod = jdit.DiT(tv=True, chain_blocks=True, **MINI_DIT)
    a = {k: jnp.asarray(v) for k, v in _inputs().items()}
    x, tt = a.pop("x"), a.pop("t")
    v = fill_zero_leaves(np_tree(mod.init(jax.random.PRNGKey(0), x, tt,
                                          remap_timesteps=False, **a)), 7)
    inp = _inputs(1)
    a = {k: jnp.asarray(w) for k, w in inp.items()}
    seed = np.array([True, False])
    want, want_feat = mod.apply(v, a.pop("x"), a.pop("t"),
                                seed_init_feat=jnp.asarray(seed),
                                remap_timesteps=True, **a)
    net = port(dit.DiT(**MINI_DIT, chain_blocks=True, dropout=0.0), v)
    with torch.no_grad():
        got, feat = net(
            t(inp["x"]), t(inp["t"]), init_flow=t(inp["init_flow"]),
            init_feat=nchw(inp["init_feat"]), y512=nchw(inp["y512"]),
            mask_cat=nchw(inp["mask_cat"]), mask_y512=nchw(inp["mask_y512"]),
            line_msk=nchw(inp["line_msk"]),
            seed_init_feat=torch.from_numpy(seed), remap_timesteps=True)
    delta = np.asarray(want) - inp["init_flow"]
    assert np.abs(delta).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_feat), atol=1e-4)
    # every block reads the previous one's mean: the dead-block module
    # with the same variables differs
    dead = jdit.DiT(tv=True, chain_blocks=False, **MINI_DIT)
    a = {k: jnp.asarray(w) for k, w in inp.items()}
    other, _ = dead.apply(v, a.pop("x"), a.pop("t"),
                          seed_init_feat=jnp.asarray(seed),
                          remap_timesteps=True, **a)
    assert np.abs(np.asarray(other) - np.asarray(want)).max() > 1e-3


def test_dewarp_flow_matches_the_reference_ddim_loop():
    m = dict(default_config().model.__dict__, dit_variant="DiT-mini",
             image_size=S, source_size=SRC, perception_size=64,
             compute_dtype="float32", chain_blocks=True)
    cfg = default_config().replace(model=m, diffusion={"n_batch": 2})
    d = dict(cfg.diffusion.__dict__)
    pipe = DewarpPipeline.create(cfg, "cpu")
    state = weights.draw_state(dit_chain.state_shapes(m), 2 ** 31 + 99,
                               "cpu")
    for name in ("dit", "seg", "line", "geotr"):
        getattr(pipe, name).load_state_dict(
            {k[len(name) + 1:]: v for k, v in state.items()
             if k.startswith(name + ".")}, strict=True)
    ref = dit_chain.Reference(m, d, state, "cpu")
    src = pages.pages(2, SRC, SRC, torch.Generator().manual_seed(3))
    flow = pipe.dewarp_flow(src, generator=torch.Generator().manual_seed(9))
    want = ref.flow(src, ref.draw_xt(9, 2))
    assert want.abs().max() > 0.05
    assert (flow - want).abs().max() <= 1e-5
