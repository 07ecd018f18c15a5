"""Weight bridge: ``dvd_tpu`` flax variables -> the port's state_dicts.

The port's module attributes follow the flax parameter paths, so the
bridge is a name map plus two layout changes:

- a flax ``kernel`` becomes ``weight``: Dense (in, out) -> (out, in), Conv
  HWIO -> OIHW;
- every other leaf keeps its name and value: ``bias``, LayerNorm/BN
  ``scale``, and the BN statistics ``mean``/``var`` (the flax
  ``batch_stats`` collection).  Nothing is folded here; the aux nets fold
  BN into K2's epilogue at run time (``models/layers.py:fold_conv_bn``).

Variables are nested dicts of numpy arrays (``{"params": ...,
"batch_stats": ...}``), as ``dvd_tpu``'s ``Module.init`` returns after
``jax.device_get`` or as ``dvd_tpu/training/convert.py`` builds them from
the reference's torch checkpoints.  No JAX import is needed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

# subtrees of a flax variable tree that have no counterpart in the port,
# by model: GeoTrSegInf's GeoTr transformer is dead in the shipped config
# (use_init_flow=False) and is not ported yet
SKIP = {
    "geotr": ("GeoTr.",),
}


class ConvertReport(NamedTuple):
    missing: List[str]      # state_dict keys the variables did not provide
    unexpected: List[str]   # converted keys the module does not have
    skipped: List[str]      # flax keys deliberately left out (see SKIP)


def flatten_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """Merge the params and batch_stats collections into dotted paths."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            p = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, p)
            else:
                out[p] = np.asarray(v)

    for coll in ("params", "batch_stats"):
        walk(variables.get(coll, {}), "")
    return out


def flax_leaf_to_torch(key: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    path, _, leaf = key.rpartition(".")
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {arr.ndim} at {key}")
        leaf = "weight"
    return (f"{path}.{leaf}" if path else leaf), np.ascontiguousarray(arr)


def variables_to_state_dict(variables: Mapping, module: nn.Module,
                            skip: Iterable[str] = ()
                            ) -> Tuple[Dict[str, torch.Tensor], ConvertReport]:
    """Flax variables -> a state_dict for ``module`` (dtypes follow the
    module) and a report of missing, unexpected and skipped keys.  Shape
    mismatches raise."""
    skip = tuple(skip)
    target = module.state_dict()
    sd: Dict[str, torch.Tensor] = {}
    unexpected, skipped = [], []
    for key, arr in sorted(flatten_variables(variables).items()):
        if key.startswith(skip):
            skipped.append(key)
            continue
        tkey, tarr = flax_leaf_to_torch(key, arr)
        if tkey not in target:
            unexpected.append(tkey)
            continue
        if tuple(target[tkey].shape) != tarr.shape:
            raise ValueError(f"{tkey}: shape {tarr.shape} vs module "
                             f"{tuple(target[tkey].shape)}")
        sd[tkey] = torch.from_numpy(tarr).to(target[tkey].dtype)
    missing = sorted(set(target) - set(sd))
    return sd, ConvertReport(missing, unexpected, skipped)


def load_variables(module: nn.Module, variables: Mapping,
                   skip: Iterable[str] = ()) -> ConvertReport:
    """Convert and load; raises unless every module key is provided and
    every converted key is used (deliberate skips are reported)."""
    sd, report = variables_to_state_dict(variables, module, skip)
    if report.missing or report.unexpected:
        raise ValueError(f"weight bridge: missing {report.missing[:8]} "
                         f"unexpected {report.unexpected[:8]}")
    module.load_state_dict(sd)
    return report
