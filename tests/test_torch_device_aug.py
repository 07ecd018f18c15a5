"""The on-device augmentation of ``dvd_tpu_torch`` (``data/device_aug.py``)
against ``dvd_tpu``'s on the CPU: the HSV conversions, the colour jitter
at given factors, the intermediate warp, the whole ``augment_batch`` with
the factors ``dvd_tpu`` draws from its key, and the raw batch's
preparation (augmentation + ``build_device_batch``) at the tiny training
configuration with the same aux-net weights.

Bars: HSV 1e-6; the jitter, the warp and ``augment_batch`` 1e-5, the
flows exact; the batch preparation 2e-4, the aux nets' bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.data import device_aug as J
from dvd_tpu.training.train_loop import build_device_batch as j_build_batch
from dvd_tpu.training.train_loop import train_aux_vars
from dvd_tpu_torch.data import device_aug as P
from dvd_tpu_torch.training.train_loop import build_device_batch
from test_torch_common import (COND_KEYS, S, SRC, smooth_field, t,
                               train_pipelines)


def _raw(rng, b=2, h=SRC):
    """A raw augmentation batch: a page in [0, 255], a soft mask, a smooth
    backward-map offset field of a few pixels."""
    return {"image512": (rng.rand(b, h, h, 3) * 255).astype(np.float32),
            "doc_mask512": np.clip(rng.rand(b, h, h, 1) * 1.5, 0, 1)
            .astype(np.float32),
            "flow_map": smooth_field(rng, b, h, 4.0)}


def _jax_factors(key, b, strength=0.1):
    """The four jitter factors as ``dvd_tpu``'s augment_batch draws them
    from its key (``dvd_tpu/data/device_aug.py:111-118``)."""
    kb, kc, ks, kh = jax.random.split(key, 4)

    def u(k, lo, hi):
        return np.asarray(jax.random.uniform(k, (b,), jnp.float32, lo, hi))

    return (u(kb, 1 - strength, 1 + strength),
            u(kc, 1 - strength, 1 + strength),
            u(ks, 1 - strength, 1 + strength), u(kh, -strength, strength))


@pytest.mark.parametrize("h", [64, 512])
def test_base_grid_equals_jnp_linspace(h):
    """The warp's base equals ``jnp.linspace(-1, 1, h, dtype=float32)`` as
    ``dvd_tpu``'s jitted batch preparation computes it, bit for bit (an
    eager ``jnp.linspace`` call, whose multiply-adds XLA contracts into
    FMAs, is within one f32 ulp of 1 of it)."""
    got = P.inter_grid(torch.zeros((1, h, h, 2)), 0.0)[0].numpy()
    want = np.asarray(jax.jit(
        lambda z: jnp.linspace(-1.0, 1.0, h, dtype=jnp.float32) + z)(
            jnp.zeros((h,), jnp.float32)))
    np.testing.assert_array_equal(got[0, :, 0], want)
    np.testing.assert_array_equal(got[:, 0, 1], want)
    eager = np.asarray(jnp.linspace(-1.0, 1.0, h, dtype=jnp.float32))
    assert np.abs(want - eager).max() <= 2.0 ** -23


def _j_augment(raw, key, frac, jitter=True):
    """``dvd_tpu``'s augment_batch under jit, as its train loop runs it."""
    return jax.jit(lambda r, k: J.augment_batch(r, k, inter_frac=frac,
                                                jitter=jitter))(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)


def test_hsv_conversions_match():
    """Random colours plus the select order's ties (two channels at the
    maximum), greys, black, and a hue that rounds up to 1.0, where
    ``i % 6`` wraps sector 6 to 0."""
    rng = np.random.RandomState(0)
    rgb = rng.rand(4, 24, 24, 3).astype(np.float32)
    rgb[0, 0, :6] = [[0.5, 0.5, 0.2], [0.2, 0.7, 0.7], [0.7, 0.2, 0.7],
                     [0.3, 0.3, 0.3], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]
    hsv_j = np.asarray(J.rgb_to_hsv(jnp.asarray(rgb)))
    hsv_p = P.rgb_to_hsv(t(rgb)).numpy()
    np.testing.assert_allclose(hsv_p, hsv_j, rtol=0, atol=1e-6)
    hsv = hsv_j.copy()
    hsv[1, 0, 0, 0] = 1.0                 # h * 6 = 6.0
    hsv[1, 0, 1, 0] = np.nextafter(np.float32(1), np.float32(0))
    np.testing.assert_allclose(P.hsv_to_rgb(t(hsv)).numpy(),
                               np.asarray(J.hsv_to_rgb(jnp.asarray(hsv))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("factors", [
    (1.0, 1.0, 1.0, 0.0),
    (1.1, 0.9, 1.1, 0.1),
    (0.9, 1.1, 0.9, -0.1),
    (1.07, 0.93, 1.05, 0.06),
    "per-sample",
])
def test_color_jitter_matches(factors):
    rng = np.random.RandomState(1)
    img = rng.rand(3, 32, 24, 3).astype(np.float32)
    if factors == "per-sample":
        f = [rng.uniform(0.9, 1.1, 3) for _ in range(3)] \
            + [rng.uniform(-0.1, 0.1, 3)]
    else:
        f = [np.full((3,), v) for v in factors]
    f = [np.asarray(x, np.float32) for x in f]
    want = np.asarray(J.apply_color_jitter(jnp.asarray(img),
                                           *map(jnp.asarray, f)))
    got = P.apply_color_jitter(t(img), *map(t, f)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("frac", [0.0, 0.35])
def test_warp_matches(frac):
    """``augment_batch`` without jitter: image and mask (one launch of the
    gather over the stack of four channels) within 1e-5, the flows exact."""
    raw = _raw(np.random.RandomState(2))
    want = _j_augment(raw, jax.random.PRNGKey(0), frac, jitter=False)
    got = P.augment_batch({k: t(v) for k, v in raw.items()}, None,
                          inter_frac=frac)
    assert set(got) == set(want)
    for k in ("source_image", "doc_mask"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    for k in ("flow_map", "flow_map_inter"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_augment_batch_with_jax_factors():
    """The whole augmentation: ``dvd_tpu``'s factors drawn from its key,
    handed to the port; and the port's own draws are uniform in range
    and reproducible from the generator's seed."""
    raw = _raw(np.random.RandomState(3))
    key = jax.random.PRNGKey(7)
    want = _j_augment(raw, key, 0.35)
    factors = tuple(t(f) for f in _jax_factors(key, 2))
    got = P.augment_batch({k: t(v) for k, v in raw.items()}, factors,
                          inter_frac=0.35)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    draws = [P.jitter_factors(64, torch.Generator().manual_seed(5))
             for _ in range(2)]
    for a, b, (lo, hi) in zip(*draws, [(0.9, 1.1)] * 3 + [(-0.1, 0.1)]):
        assert torch.equal(a, b) and a.dtype == torch.float32
        assert lo <= a.min() and a.max() <= hi and a.std() > 0.03


def test_raw_batch_prep_matches():
    """A raw batch's preparation, ``augment_batch`` then
    ``build_device_batch``, against ``dvd_tpu``'s at the tiny training
    configuration with the same aux-net weights: every conditioning
    stream and flow target within the aux nets' 2e-4."""
    raw = _raw(np.random.RandomState(4))
    key = jax.random.PRNGKey(11)
    jaug = _j_augment(raw, key, 0.35)
    _, _, jp, pipe = train_pipelines(
        [np.asarray(jaug["source_image"])], on_device_aug=True)
    jb = jax.jit(lambda aux, r: j_build_batch(jp, aux, r, S))(
        train_aux_vars(jp), jaug)
    aug = P.augment_batch({k: t(v) for k, v in raw.items()},
                          tuple(t(f) for f in _jax_factors(key, 2)),
                          inter_frac=0.35)
    pb = build_device_batch(pipe, aug, S)
    assert set(pb) == set(jb)
    for k, a in jb.items():
        got = pb[k].permute(0, 2, 3, 1) if k in COND_KEYS else pb[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=2e-4,
                                   rtol=1e-4, err_msg=k)
