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


def port(module: torch.nn.Module, variables):
    """Load flax ``variables`` into the port ``module`` (eval mode)."""
    load_variables(module, variables)
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


def torch_named(jax_tree, module: torch.nn.Module, collection="params"):
    """A flax tree (parameters, gradients, EMA) under the port module's
    state_dict names, as numpy arrays (Dense/Conv kernels transposed)."""
    from dvd_tpu_torch.training.convert import variables_to_state_dict

    sd, _ = variables_to_state_dict({collection: np_tree(jax_tree)}, module)
    return {k: v.numpy() for k, v in sd.items()}


def assert_trees_close(got: dict, want: dict, rel: float, floor: float = 1.0):
    """Every tensor of ``want`` matched in ``got`` within ``rel * max(floor,
    max |want|)``, each against its own largest element (gradients of
    different layers differ by orders of magnitude)."""
    assert set(want) <= set(got), sorted(set(want) - set(got))[:5]
    for k, w in want.items():
        g = np.asarray(got[k].detach() if torch.is_tensor(got[k]) else got[k])
        bar = rel * max(floor, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= bar, f"{k}: max err {err:.3e} > {bar:.3e}"


def no_flax_dropout(monkeypatch) -> None:
    """flax ``nn.Dropout`` as the identity for one test (the port's side
    builds its modules with ``dropout=0``): the two frameworks draw
    different random bits, so the parity tests run without dropout."""
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def random_variables(module, *args, seed: int = 0, **kwargs):
    """Seeded random flax variables for ``module`` without compiling its
    init (``jax.eval_shape`` gives the tree), drawn as the port's
    ``seeded_init_`` draws: kernels N(0, 1/fan_in), except the DiT's
    zero-initialised adaLN and final layers, N(0, 0.02^2) (so they carry
    signal without dominating); norm scales 1 + N(0, 0.02^2); BN
    variances in [0.5, 1.5]; every other leaf N(0, 0.02^2)."""
    from dvd_tpu_torch.models.layers import ZERO_INIT_LAYERS

    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kwargs))
    rng = np.random.RandomState(seed)
    small = tuple(z.rstrip(".").replace(".", "/") for z in ZERO_INIT_LAYERS)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(v, f"{path}/{k}") for k, v in sorted(node.items())}
        shape, leaf = tuple(node.shape), path.rsplit("/", 1)[-1]
        if leaf == "kernel" and not any(z in path for z in small):
            val = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            val = 1 + 0.02 * rng.randn(*shape)
        elif leaf == "var":
            val = 0.5 + rng.rand(*shape)
        else:
            val = 0.02 * rng.randn(*shape)
        return val.astype(np.float32)

    return walk(shapes, "")


# the tiny training configuration of tests/test_train_step.py: latent 16,
# source 128, a DiT 48 wide and 2 deep
S, SRC = 16, 128
MINI_DIT = dict(input_size=S, patch_size=2, hidden_size=48, depth=2,
                num_heads=3)
TINY_MODEL = dict(image_size=S, source_size=SRC, perception_size=64,
                  compute_dtype="float32")


def mini_dit_variables(seed: int = 11):
    """(flax DiT-mini, its seeded random variables)."""
    from dvd_tpu.models.dit import DiT as JDiT

    mod = JDiT(tv=True, chain_blocks=False, **MINI_DIT)
    z = jax.numpy.zeros
    v = random_variables(
        mod, z((1, S, S, 2)), z((1,)), y512=z((1, SRC, SRC, 3)),
        mask_cat=z((1, SRC, SRC, 1)), mask_y512=z((1, S, S, 384)),
        line_msk=z((1, S, S, 64)), init_flow=z((1, S, S, 2)),
        init_feat=z((1, S, S, 256)), remap_timesteps=False, seed=seed)
    return mod, v


def mini_dit_port(variables):
    """The port's DiT-mini with ``variables``, dropout off."""
    from dvd_tpu_torch.models.dit import DiT

    return port(DiT(**MINI_DIT, dropout=0.0), variables)


def smooth_field(rng, b: int, h: int, amp: float) -> np.ndarray:
    """A smooth random (B, h, h, 2) field, a sum of three low sinusoids:
    sampling coordinates built from it are not whole pixels (where the
    bilinear sampler's gradient has its kink)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, h),
                         indexing="ij")
    out = np.zeros((b, h, h, 2))
    for _ in range(3):
        a = rng.randn(b, 1, 1, 2) * amp
        fx, fy, ph = rng.rand(3) * 3
        out += a * np.sin(2 * np.pi * (fx * xx + fy * yy + ph))[None, ..., None]
    return out.astype(np.float32)


COND_KEYS = ("y512", "mask_cat", "mask_y512", "line_msk")


def train_batch(b: int = 2, seed: int = 1):
    """The JAX train step's batch (NHWC jnp) and the port's (NCHW
    conditioning, channel-last flows)."""
    rng = np.random.RandomState(seed)
    jb = {
        "y512": rng.rand(b, SRC, SRC, 3).astype(np.float32),
        "mask_cat": np.ones((b, SRC, SRC, 1), np.float32),
        "mask_y512": (0.1 * rng.randn(b, S, S, 384)).astype(np.float32),
        "line_msk": (0.1 * rng.randn(b, S, S, 64)).astype(np.float32),
        "flow64": smooth_field(rng, b, S, 0.05),
        "flow_inter": smooth_field(rng, b, SRC, 0.02),
        "mask": np.ones((b, SRC, SRC, 1), np.float32),
    }
    pb = {k: nchw(v) if k in COND_KEYS else t(v) for k, v in jb.items()}
    return {k: jax.numpy.asarray(v) for k, v in jb.items()}, pb


def train_pipelines(sources, **train_over):
    """(JAX config, port config, JAX pipeline, port pipeline) at the tiny
    training configuration with ``train_over`` set, the same random aux
    weights on both sides and DiT-mini's (``mini_dit_variables``) in the
    port's; U2NetP's ``outconv`` bias shifted so the soft mask of every
    source image in ``sources`` ((B, SRC, SRC, 3) arrays in [0, 1]) stays
    clear of the hard threshold (``mask_margin_shift``)."""
    import jax.numpy as jnp

    from dvd_tpu.config import default_config as j_default_config
    from dvd_tpu.evaluation.pipeline import DewarpPipeline as JPipeline
    from dvd_tpu.models.dit import DiT as JDiT
    from dvd_tpu.models.u2net import U2NetP as JU2NetP
    from dvd_tpu.ops.resize import resize_bilinear as j_resize
    from dvd_tpu_torch.config import default_config
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline

    over = dict(model=TINY_MODEL, train=train_over)
    jcfg = j_default_config().replace(**over)
    cfg = default_config().replace(**over)
    jp = JPipeline.create(jcfg)
    jp.dit = JDiT(tv=True, chain_blocks=False, **MINI_DIT)   # unused here
    jp.init_params(jax.random.PRNGKey(0))
    seg_vars, line_vars = np_tree(jp.seg_vars), np_tree(jp.line_vars)
    msk = {"params": seg_vars["params"]["msk"],
           "batch_stats": seg_vars["batch_stats"]["msk"]}
    d0 = np.concatenate([np.asarray(JU2NetP(1).apply(msk, j_resize(
        jnp.asarray(src), (64, 64), align_corners=True))[0])
        for src in sources])
    seg_vars["params"]["msk"]["outconv"]["bias"] += mask_margin_shift(d0)
    jp.seg_vars, jp.line_vars = seg_vars, line_vars
    pipe = DewarpPipeline.create(cfg, "cpu", dit=mini_dit_port(
        mini_dit_variables()[1]), train=True)
    port(pipe.seg, seg_vars)
    port(pipe.line, line_vars)
    return jcfg, cfg, jp, pipe
