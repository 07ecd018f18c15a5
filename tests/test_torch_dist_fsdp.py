"""FSDP in the port's train step (``parallel/mesh.py``: the largest-axis
rule, ``ShardedParams``) in a 2-process gloo world on the CPU at data=2,
against the single-process step on the global batch; and checkpoints
across layouts: written under FSDP, gathered to the unsharded layout,
resumed under tensor parallelism and by one process, and served
unsharded.

The step in float64 on both sides, at ``tests/test_multihost.py``'s bars
(see ``test_torch_dist_train.py``); ``train()`` in f32 at lr 1e-6 (at
the shipped lr AdamW's sign-like first updates turn rounding-level
gradient differences into steps of 2 lr: ``test_torch_train_trajectory``).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.diffusion.schedule import make_schedule
from dvd_tpu_torch.models.dit import DIT_CONFIGS, DiT
from dvd_tpu_torch.models.layers import seeded_init_
from dvd_tpu_torch.training import checkpoint as ckpt
from dvd_tpu_torch.training.convert import variables_to_state_dict
from dvd_tpu_torch.training.train_loop import train
from dvd_tpu_torch.training.train_state import (create_train_state,
                                                make_train_step)
from test_torch_common import (S, SRC, TINY_MODEL, assert_trees_close,
                               recorded_step, run_world, smooth_field, t,
                               train_batch)

DIT4 = dict(input_size=S, patch_size=2, hidden_size=48, depth=2,
            num_heads=4)


def test_fsdp_step_matches_single_process(tmp_path):
    """One step at data=2 with fsdp: loss, gradients (gathered from the
    shards), parameters, EMA; every sharded tensor is half its largest
    axis, and the optimizer holds those halves."""
    net = seeded_init_(DiT(dropout=0.0, **DIT4),
                       torch.Generator().manual_seed(1))
    sd = net.state_dict()
    _, pb = train_batch(4, seed=7)
    rng = np.random.RandomState(8)
    pins = {"t": torch.tensor([2, 0, 1, 2]),
            "noise": t(rng.randn(4, S, S, 2).astype(np.float32)),
            "rollout_noise": t(rng.randn(4, S, S, 2).astype(np.float32))}
    cfg = default_config().replace(model=TINY_MODEL)
    net.double()
    state = create_train_state(cfg, net)
    state, m, grads = recorded_step(
        make_train_step(cfg, make_schedule(steps=3)), state,
        {k: v.double() for k, v in pb.items()},
        **{k: v.double() if v.is_floating_point() else v
           for k, v in pins.items()})
    w = run_world("step", dict(
        cfg={"model": TINY_MODEL, "parallel": {"fsdp": True}}, dit=DIT4,
        state_dict=sd, batch=pb, mesh=(2, 1), dtype=torch.float64, **pins),
        tmp_path)
    assert abs(w["loss"] - m["loss"].item()) < 1e-5
    assert_trees_close(w["grads"], {k: g.numpy() for k, g in grads.items()},
                       rel=1e-4, floor=1e-12)
    assert_trees_close(w["state"], {k: v.numpy() for k, v in
                                    state.model.state_dict().items()},
                       rel=1e-6)
    assert_trees_close(w["ema"], {k: v.numpy() for k, v in
                                  state.ema_params[0].items()}, rel=1e-6)
    placed = w["placements"]
    assert len(placed) > 100
    for name, (kind, axis, local) in placed.items():
        full = tuple(sd[name].shape)
        assert kind == "data" and axis == int(np.argmax(full)), name
        assert local[axis] * 2 == full[axis] and \
            local[:axis] + local[axis + 1:] == full[:axis] + full[axis + 1:]
    assert placed["decoder.layer_stack_0.attn.linear_q.weight"] == \
        ("data", 0, (768, 192))
    small = [n for n, v in sd.items() if max(v.shape, default=0) < 4]
    assert not set(small) & set(placed)


def _wire(n_batches, b, seed=0):
    rng = np.random.RandomState(seed)
    return [{"source_image": rng.rand(b, SRC, SRC, 3).astype(np.float32),
             "doc_mask": np.ones((b, SRC, SRC, 1), np.float32),
             "flow_map": smooth_field(rng, b, SRC, 3.0),
             "flow_map_inter": smooth_field(rng, b, SRC, 2.0)}
            for _ in range(n_batches)]


def test_checkpoint_across_layouts(tmp_path, monkeypatch):
    """A step under FSDP (data=2) writes a checkpoint in the unsharded
    layout, close to the single process's; a second step resumed from it
    under TP (model=2) and by one process agree; the EMA snapshot of the
    TP run loads into an unsharded DiT."""
    monkeypatch.setitem(DIT_CONFIGS, "DiT-mini4", DIT4)
    over = dict(model=dict(TINY_MODEL, dit_variant="DiT-mini4"),
                train=dict(on_device_aug=False, save_interval=1000,
                           lr=1e-6))
    batches = _wire(2, 4)

    def cfg(ws, **par):
        return default_config().replace(
            **over, parallel=par, paths=dict(workspace_dir=str(ws)))

    spec = dict(batches=batches, dit_configs={"DiT-mini4": DIT4})
    run_world("train", dict(spec, cfg=dict(
        over, parallel={"fsdp": True},
        paths={"workspace_dir": str(tmp_path / "fsdp")}),
        mesh=(2, 1), max_steps=1), tmp_path)
    train(cfg(tmp_path / "one"), iter(batches), max_steps=1,
          device="cpu")
    a = torch.load(tmp_path / "fsdp" / "default" / "state_00000001.pt",
                   weights_only=True)
    b = torch.load(tmp_path / "one" / "default" / "state_00000001.pt",
                   weights_only=True)
    assert a["step"] == b["step"] == 1
    for key in ("model", "ema_params"):
        x = a[key] if key == "model" else a[key][0]
        y = b[key] if key == "model" else b[key][0]
        assert {k: v.shape for k, v in x.items()} == \
            {k: v.shape for k, v in y.items()}
        assert_trees_close(x, {k: v.numpy() for k, v in y.items()},
                           rel=1e-5)
    for i, st in b["optimizer"]["adamw"]["state"].items():
        got = a["optimizer"]["adamw"]["state"][i]
        assert got["exp_avg"].shape == st["exp_avg"].shape

    # resume the FSDP checkpoint under TP and in one process
    for ws in ("tp", "one2"):
        os.makedirs(tmp_path / ws / "default")
        shutil.copy(tmp_path / "fsdp" / "default" / "state_00000001.pt",
                    tmp_path / ws / "default")
    out = run_world("train", dict(spec, cfg=dict(
        over, parallel={"model_axis": 2},
        paths={"workspace_dir": str(tmp_path / "tp")}),
        mesh=(1, 2), max_steps=2, start=1), tmp_path)
    assert out["step"] == 2 and "blocks_1.attn.qkv.weight" in out["sharded"]
    one = train(cfg(tmp_path / "one2"), iter(batches[1:]), max_steps=2,
                device="cpu")
    c = torch.load(tmp_path / "tp" / "default" / "state_00000002.pt",
                   weights_only=True)
    assert c["step"] == 2
    assert_trees_close(c["model"], {k: v.numpy() for k, v in
                                    one.model.state_dict().items()},
                       rel=1e-5)
    snap = ckpt.load_variables(str(tmp_path / "tp" / "default"
                                   / "ema_0.9999_000002.msgpack"))
    sd, report = variables_to_state_dict(snap, DiT(dropout=0.0, **DIT4))
    assert report == ([], [], [])
    assert sd["blocks_1.attn.qkv.weight"].shape == (144, 48)
