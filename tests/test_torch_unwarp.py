"""The fused unwarp's plain version (``ops/kernels/unwarp.py``: what the
CPU runs and what the card's kernel is held to) against ``dvd_tpu``'s
``unwarp_native`` and ``unwarp_fixed`` on the CPU, at sizes that are
neither square nor multiples of the TPU kernel's tiles, f32 and uint8.
The wrapper's own routing (CPU -> plain version) is in
``test_torch_ops.py``; the kernel against this plain version is in
``test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.evaluation.pipeline import unwarp_fixed as j_unwarp_fixed
from dvd_tpu.evaluation.pipeline import unwarp_native as j_unwarp_native
from dvd_tpu_torch.ops.kernels.unwarp import unwarp
from test_torch_common import t


def _canvas(rng, p, hws, c=3):
    pad = np.zeros((len(hws), p, p, c), np.uint8)
    for i, (h, w) in enumerate(hws):
        pad[i, :h, :w] = rng.randint(0, 256, (h, w, c))
    return pad


@pytest.mark.parametrize("p,hws", [(97, [(97, 61), (40, 97)]),
                                   (130, [(129, 75), (33, 130)])])
def test_native_f32_matches_dvd_tpu(p, hws):
    """f32 out from a uint8 canvas (``dvd_tpu`` returns its source's dtype,
    so it gets the same canvas in f32), per page inside its (h, w).  The
    flow upsample is a matmul on the JAX side and two lerps here, so a
    coordinate may differ by its f32 rounding (about 1e-5 px at 130 px),
    which a random page (up to 255 levels a pixel) turns into up to 3e-3
    of value: 5e-3 on [0, 255]."""
    rng = np.random.RandomState(p)
    pad = _canvas(rng, p, hws)
    hw = np.array(hws, np.int32)
    flow = ((rng.rand(2, 16, 16, 2) - 0.5) * 0.1).astype(np.float32)
    want = np.asarray(j_unwarp_native(jnp.asarray(pad, jnp.float32),
                                      jnp.asarray(hw), jnp.asarray(flow)))
    got = unwarp(torch.from_numpy(pad), t(flow), torch.from_numpy(hw))
    assert got.dtype == torch.float32
    for i, (h, w) in enumerate(hws):
        np.testing.assert_allclose(got[i, :h, :w].numpy(), want[i, :h, :w],
                                   atol=5e-3)


@pytest.mark.parametrize("p,hws", [(97, [(97, 61), (40, 97)]),
                                   (130, [(129, 75), (33, 130)])])
def test_native_uint8_matches_dvd_tpu(p, hws):
    """uint8 out (round half to even, clip) against ``jnp.round`` and
    ``jnp.clip`` of ``dvd_tpu``'s f32 result: within 1 level (a sum that
    lands on .5 may round the other way)."""
    rng = np.random.RandomState(p + 1)
    pad = _canvas(rng, p, hws)
    hw = np.array(hws, np.int32)
    flow = ((rng.rand(2, 16, 16, 2) - 0.5) * 0.1).astype(np.float32)
    want = np.asarray(jnp.clip(jnp.round(j_unwarp_native(
        jnp.asarray(pad, jnp.float32), jnp.asarray(hw), jnp.asarray(flow))),
        0, 255))
    got = unwarp(torch.from_numpy(pad), t(flow), torch.from_numpy(hw),
                 out_u8=True)
    assert got.dtype == torch.uint8
    for i, (h, w) in enumerate(hws):
        d = np.abs(got[i, :h, :w].numpy().astype(np.int32)
                   - want[i, :h, :w].astype(np.int32))
        assert d.max() <= 1


@pytest.mark.parametrize("hw", [(45, 60), (33, 130), (77, 77)])
def test_fixed_matches_dvd_tpu(hw):
    """A page at its own size (``unwarp_fixed``), f32 in [0, 1]; the same
    coordinate rounding on a random page (up to 1 a pixel): 3e-5."""
    rng = np.random.RandomState(hw[1])
    src = rng.rand(2, *hw, 3).astype(np.float32)
    flow = ((rng.rand(2, 16, 16, 2) - 0.5) * 0.2).astype(np.float32)
    want = np.asarray(j_unwarp_fixed(jnp.asarray(src), jnp.asarray(flow)))
    got = unwarp(t(src), t(flow)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)
