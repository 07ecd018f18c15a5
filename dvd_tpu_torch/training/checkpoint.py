"""Checkpoints (port of ``dvd_tpu/training/checkpoint.py``; reference
``train_util.py:148-204, 599-657``, ``local.py:77-80``).

Two formats:

- **Model variable files** (``.msgpack``): flax-serialized variable trees
  ``{"params", "batch_stats"}``, read and written by ``utils/msgpack_io``
  without flax.  They are what ``cli/convert_ckpt.py`` (and ``dvd_tpu``'s
  converter) write from the reference's torch checkpoints, what
  :func:`maybe_load_pipeline_weights` serves, and the per-rate EMA
  snapshots ``ema_{rate}_{step:06d}.msgpack`` of training (the
  reference's ``ema_{rate}_{step:06d}.pt`` naming); either package reads
  the other's files.
- **Train state** ``state_{step:08d}.pt``: the whole train state (step,
  DiT parameters and BN running statistics, optimizer, EMA trees, sampler
  history) in one ``torch.save`` file, written under a temporary name and
  renamed, so a reader never sees half a checkpoint.  (The JAX package's
  orbax directories have no PyTorch counterpart.)
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import torch

from dvd_tpu_torch.training import resample
from dvd_tpu_torch.training.convert import (load_variables as
                                            load_into_module,
                                            state_dict_to_variables)
from dvd_tpu_torch.utils.msgpack_io import msgpack_restore, msgpack_serialize


# --------------------------------------------------------------- msgpack IO
def _atomic_write(data: bytes, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_variables(path: str, variables: Mapping[str, Any]) -> None:
    """Write a variable tree (dicts of tensors or numpy arrays) as a flax
    msgpack file."""
    _atomic_write(msgpack_serialize(dict(variables)), path)


def load_variables(path: str) -> Dict[str, Any]:
    """A flax msgpack variable file -> its tree (CPU tensors)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# pipeline attribute, the key of maybe_load_pipeline_weights' report (the
# JAX pipeline's variable names) and the config path it is loaded from
PIPELINE_WEIGHTS = (("dit", "dit_vars", "model_path"),
                    ("geotr", "geotr_vars", "seg_model_path"),
                    ("line", "line_vars", "line_seg_model_path"),
                    ("seg", "seg_vars", "new_seg_model_path"))


def weight_file(path: str) -> Optional[str]:
    """The first of ``path``, ``path + ".msgpack"`` and ``path`` with its
    ``.pt``/``.pth``/``.npz`` suffix replaced by ``.msgpack`` that is a
    file, else None."""
    for cand in (path, path + ".msgpack",
                 re.sub(r"\.(pt|pth|npz)$", ".msgpack", path)):
        if os.path.isfile(cand):
            return cand
    return None


def maybe_load_pipeline_weights(pipe, cfg) -> Dict[str, bool]:
    """Load the converted weight files that exist at ``cfg.paths`` into
    the pipeline's networks in place (reference ``local.py:77-80``) and
    return which were loaded, ``{"dit_vars": True, ...}``; networks
    without a file keep their weights.  A file that does not fit its
    network raises (the bridge's missing/unexpected-key check).  A
    ``seg_model_path`` file fills the whole ``GeoTrSegInf`` under
    ``use_init_flow=True``; without it the mask-only module skips the
    file's ``GeoTr`` subtree (``GeoTrSegInf.absent_subtrees``).  The VGG
    pyramid has no path of its own, as in ``dvd_tpu``: it keeps its seeded
    weights unless a converted file is loaded into ``pipe.vgg``."""
    loaded = {}
    for attr, key, path_field in PIPELINE_WEIGHTS:
        path = weight_file(getattr(cfg.paths, path_field))
        if path is not None:
            load_into_module(getattr(pipe, attr), load_variables(path))
        loaded[key] = path is not None
    return loaded


# --------------------------------------------------------------- train state

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
    """One ``ema_{rate}_{step:06d}.msgpack`` per EMA rate: the DiT's
    variables ``{"params": EMA parameters, "batch_stats": the current BN
    running statistics}``, loadable as a model variable file (by
    :func:`maybe_load_pipeline_weights` and by ``dvd_tpu``)."""
    base = state.model.state_dict()
    for rate, tree in zip(cfg.train.ema_rates, state.ema_params):
        sd = dict(base)
        sd.update(tree)
        save_variables(os.path.join(workspace,
                                    f"ema_{rate}_{step:06d}.msgpack"),
                       state_dict_to_variables(sd))
