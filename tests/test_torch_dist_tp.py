"""Tensor parallelism of the port's train step (``parallel/mesh.py``:
``shard_params``'s column- and row-parallel layers, ``parallel/comm.py``'s
autograd pair) in a 2-process gloo world on the CPU at model=2, against
the single-process step on the same batch, and the layout it holds: whole
heads on each rank.

A tiny time-variant DiT with 4 heads (DiT-mini's 3 do not divide over 2
ranks) through the production loss (the rollout, then the supervised
call), in float64 on both sides (see ``test_torch_dist_train.py``: in f32
the decoder's BN turns rounding into kinks); the bars are
``tests/test_multihost.py``'s: 1e-5 on the loss, 1e-4 x max|g| on every
gradient.
"""

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.diffusion.schedule import make_schedule
from dvd_tpu_torch.models.dit import DiT
from dvd_tpu_torch.models.layers import seeded_init_
from dvd_tpu_torch.parallel import mesh as M
from dvd_tpu_torch.training.train_state import (create_train_state,
                                                make_train_step)
from test_torch_common import (S, TINY_MODEL, assert_trees_close,
                               recorded_step, run_world, t, train_batch)

DIT4 = dict(input_size=S, patch_size=2, hidden_size=48, depth=2,
            num_heads=4)


def _weights(seed=0):
    return seeded_init_(DiT(dropout=0.0, **DIT4),
                        torch.Generator().manual_seed(seed)).state_dict()


@pytest.fixture(scope="module")
def tp_step(tmp_path_factory):
    sd = _weights()
    _, pb = train_batch(2, seed=5)
    rng = np.random.RandomState(6)
    pins = {"t": torch.tensor([0, 2]),
            "noise": t(rng.randn(2, S, S, 2).astype(np.float32)),
            "rollout_noise": t(rng.randn(2, S, S, 2).astype(np.float32))}
    cfg = default_config().replace(model=TINY_MODEL)
    net = DiT(dropout=0.0, **DIT4)
    net.load_state_dict(sd)
    net.double()
    state = create_train_state(cfg, net)
    step = make_train_step(cfg, make_schedule(steps=3))
    p64 = {k: v.double() for k, v in pb.items()}
    state, m, grads = recorded_step(
        step, state, p64, **{k: v.double() if v.is_floating_point() else v
                             for k, v in pins.items()})
    w = run_world("step", dict(
        cfg={"model": TINY_MODEL}, dit=DIT4, state_dict=sd, batch=pb,
        mesh=(1, 2), dtype=torch.float64, **pins),
        tmp_path_factory.mktemp("tp"))
    return sd, state, m, grads, w


def test_tp_step_matches_single_process(tp_step):
    _, state, m, grads, w = tp_step
    assert abs(w["loss"] - m["loss"].item()) < 1e-5
    assert_trees_close(w["grads"], {k: g.numpy() for k, g in grads.items()},
                       rel=1e-4, floor=1e-12)
    np.testing.assert_allclose(w["grad_norm"], m["grad_norm"].item(),
                               rtol=1e-6)
    want = {k: v.numpy() for k, v in state.model.state_dict().items()}
    assert_trees_close(w["state"], want, rel=1e-6)
    assert_trees_close(w["ema"], {k: v.numpy() for k, v in
                                  state.ema_params[0].items()}, rel=1e-6)


def test_tp_ranks_hold_whole_heads(tp_step):
    """Rank 0 holds q, k and v's columns of its 2 heads of Dh 12 (the
    first 24 of each third of the fused qkv), the decoder's first 3 heads
    of Dh 256, half the MLP's hidden units, and the matching input
    columns of each row-parallel projection (against the unsharded
    parameters the step's checkpoint gathers)."""
    _, _, _, _, w = tp_step
    sd = w["state"]                 # gathered after the step
    heads = w["heads"]
    assert heads["blocks_1.attn"] == heads["blocks_1.cross_attn"] == 2
    assert heads["decoder.layer_stack_0.attn"] == 3
    local = w["local"]
    qkv = sd["blocks_1.attn.qkv.weight"]
    np.testing.assert_array_equal(
        local["blocks_1.attn.qkv.weight"],
        torch.cat([qkv[0:24], qkv[48:72], qkv[96:120]]))
    np.testing.assert_array_equal(local["blocks_1.attn.qkv.bias"], torch.cat(
        [sd["blocks_1.attn.qkv.bias"][o:o + 24] for o in (0, 48, 96)]))
    np.testing.assert_array_equal(local["blocks_1.attn.proj.weight"],
                                  sd["blocks_1.attn.proj.weight"][:, :24])
    lq = "decoder.layer_stack_0.attn.linear_q.weight"
    np.testing.assert_array_equal(local[lq], sd[lq][:768])
    fc = "decoder.layer_stack_0.attn.fc.weight"
    np.testing.assert_array_equal(local[fc], sd[fc][:, :768])
    np.testing.assert_array_equal(local["blocks_1.mlp.fc1.weight"],
                                  sd["blocks_1.mlp.fc1.weight"][:96])
    assert w["placements"]["blocks_1.attn.qkv.weight"] == \
        ("model", 0, (72, 48))
    # the row-parallel biases and everything else stay whole
    assert "blocks_1.attn.proj.bias" not in w["placements"]
    assert "t_embedder.mlp_0.weight" not in w["placements"]


def test_tp_rules_follow_dvd_tpu():
    """The port's rule for every DiT parameter against ``dvd_tpu``'s on the
    same (flax) path at model=2: the same parameters shard, on the axis
    that the (in, out) -> (out, in) transpose maps, with the divisibility
    fallback; then FSDP's largest-axis rule at data=4."""
    from jax.sharding import PartitionSpec as P

    from dvd_tpu.parallel import mesh as JM

    class JMesh:
        def __init__(self, **shape):
            self.shape = shape

    net = DiT(dropout=0.0, **DIT4)
    port2 = M.Mesh(data=1, model=2)
    for name, p in net.named_parameters():
        parts = name.split(".")
        leaf = {"weight": "kernel"}.get(parts[-1], parts[-1])
        path = "params/" + "/".join(parts[:-1] + [leaf])
        shape = tuple(p.shape)
        jshape = shape[::-1] if leaf == "kernel" and len(shape) == 2 \
            else shape
        want = JM.param_sharding_rules(path, jshape, JMesh(data=1, model=2))
        got = M.param_sharding_rules(name, shape, port2)
        if leaf == "kernel" and len(shape) == 2:
            want = P(*tuple(want)[::-1]) if tuple(want) else want
        assert tuple(got) == tuple(want), (name, got, want)
    for shape in ((1536, 192), (2, 2), (6, 1), (8,)):
        want = JM.param_sharding_rules("x/y", shape, JMesh(data=4, model=1),
                                       fsdp=True)
        got = M.param_sharding_rules("x.y", shape, M.Mesh(4, 1), fsdp=True)
        assert tuple(got) == tuple(want), shape
