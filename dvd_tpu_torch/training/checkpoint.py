"""Training checkpoints (port of the train-state half of
``dvd_tpu/training/checkpoint.py``; reference ``train_util.py:148-204,
599-657``).

- ``state_{step:08d}.pt``: the whole train state (step, DiT parameters
  and BN running statistics, optimizer, EMA trees, sampler history) in
  one ``torch.save`` file, written under a temporary name and renamed, so
  a reader never sees half a checkpoint;
- ``ema_{rate}_{step:06d}.pt``: per-rate EMA weights as a DiT
  ``state_dict`` (EMA parameters + the running BN statistics), the
  reference's ``ema_{rate}_{step:06d}.pt`` naming.

The JAX package's orbax directories and msgpack variable files are not
read here (orbax has no PyTorch counterpart).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from dvd_tpu_torch.training import resample


def _state_path(workspace: str, step: int) -> str:
    return os.path.join(os.path.abspath(workspace), f"state_{step:08d}.pt")


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_train_state(workspace: str, state) -> str:
    st = state.sampler_state
    path = _state_path(workspace, state.step)
    _atomic_save({
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema_params": list(state.ema_params),
        "sampler_state": None if st is None else
        {"history": st.history, "counts": st.counts},
    }, path)
    return path


def restore_train_state(path: str, state):
    """Load ``path`` into ``state`` in place (tensors go to the state's
    device) and return it."""
    dev = next(state.model.parameters()).device
    blob = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    if len(blob["ema_params"]) != len(state.ema_params):
        raise ValueError(f"{path}: {len(blob['ema_params'])} EMA trees, the "
                         f"config has {len(state.ema_params)} rates")
    with torch.no_grad():
        for ema, saved in zip(state.ema_params, blob["ema_params"]):
            for k, v in ema.items():
                v.copy_(saved[k])
    if blob["sampler_state"] is not None:
        state.sampler_state = resample.LossSecondMomentState(
            **blob["sampler_state"])
    state.step = int(blob["step"])
    return state


def latest_checkpoint(workspace: str) -> Optional[str]:
    if not os.path.isdir(workspace):
        return None
    steps = [int(m.group(1)) for m in
             (re.fullmatch(r"state_(\d+)\.pt", n) for n in os.listdir(workspace))
             if m]
    return _state_path(workspace, max(steps)) if steps else None


def save_ema_snapshots(workspace: str, cfg, state, step: int) -> None:
    """One ``ema_{rate}_{step:06d}.pt`` per EMA rate: a DiT state_dict with
    the EMA parameters and the current BN running statistics."""
    base = state.model.state_dict()
    for rate, tree in zip(cfg.train.ema_rates, state.ema_params):
        sd = dict(base)
        sd.update(tree)
        _atomic_save(sd, os.path.join(workspace, f"ema_{rate}_{step:06d}.pt"))
