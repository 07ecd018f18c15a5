"""Shared helpers for the ``dvd_tpu_torch`` parity tests (no tests here).

Both packages get the same inputs (numpy, from a seed) and the same
weights: the flax variables of the ``dvd_tpu`` module are carried into the
port's state_dict by ``dvd_tpu_torch.training.convert``.
"""

import jax
import numpy as np
import torch

from dvd_tpu_torch.training.convert import load_variables

# Tier-1 runs pytest with several workers on one host
torch.set_num_threads(1)


def np_tree(tree):
    """A flax variable tree as nested dicts of float32 numpy arrays."""
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.array(jax.device_get(tree), dtype=np.float32)


def fill_zero_leaves(tree, seed: int, std: float = 0.02):
    """Replace every all-zero leaf with seeded N(0, std^2), so zero-init
    layers (the DiT's adaLN gates and final layer) carry signal."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if hasattr(node, "items"):
            return {k: walk(v) for k, v in sorted(node.items())}
        if not node.any():
            return (std * rng.randn(*node.shape)).astype(np.float32)
        return node

    return walk(tree)


def port(module: torch.nn.Module, variables, skip=()):
    """Load flax ``variables`` into the port ``module`` (eval mode)."""
    load_variables(module, variables, skip)
    return module.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def nchw(x) -> torch.Tensor:
    return t(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def mask_margin_shift(d0: np.ndarray, margin_logit: float = 0.3) -> float:
    """Bias shift for U2NetP's ``outconv`` that puts every soft-mask pixel
    at sigmoid >= sigmoid(margin_logit) (> 0.55): with random weights,
    pixels near the hard 0.5 threshold could flip between frameworks."""
    d0 = np.clip(d0.astype(np.float64), 1e-7, 1 - 1e-7)
    z = np.log(d0 / (1 - d0))
    return float(margin_logit - z.min())
