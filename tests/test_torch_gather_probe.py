"""K5, the exact integer 2-D gather, against ``tools/pallas_gather_probe.py``
on the CPU: the Pallas probe in interpret mode, K5's plain twin on the
probe's own inputs, the port's probe entry, and the out-of-range
convention (0.0) that the CUDA kernel shares with the twin."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.ops.kernels.gather2d import gather2d, gather2d_ref
from dvd_tpu_torch.tools import gather_probe

REPO = Path(__file__).resolve().parents[1]


def test_pallas_probe_interpret_passes():
    """The TPU kernel K5 replaces, run in Pallas interpret mode."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "pallas_gather_probe.py"),
         "--interpret"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "max_err 0.0" in out.stdout and "PRIMITIVES_OK" in out.stdout


def test_twin_equals_numpy_on_the_probe_inputs():
    """The probe's arange image and its jax.random.randint indices (the
    same keys as the tool): the twin equals numpy's ``img[y, x]`` bit for
    bit, the reference the tool holds the Pallas kernel to."""
    h, w = 64, 256
    img = np.arange(h * w, dtype=np.float32).reshape(h, w)
    key = jax.random.PRNGKey(0)
    y = np.array(jax.random.randint(key, (8, 128), 13, 36), np.int32)
    x = np.array(jax.random.randint(jax.random.fold_in(key, 1), (8, 128),
                                    100, 230), np.int32)
    got = gather2d_ref(torch.from_numpy(img), torch.from_numpy(y),
                       torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (8, 128)
    np.testing.assert_array_equal(got.numpy(), img[y, x])


def test_port_probe_entry_on_cpu(capsys):
    before = gather2d.launches
    gather_probe.main(["--device", "cpu"])
    out = capsys.readouterr().out.split("\n")
    assert out[:2] == ["max_err 0.0", "PRIMITIVES_OK"]
    assert gather2d.launches == before      # the CPU takes the twin
    img, y, x = gather_probe.probe_inputs()
    assert int(y.min()) >= 13 and int(y.max()) < 36
    assert int(x.min()) >= 100 and int(x.max()) < 230


@pytest.mark.parametrize("hw,mn", [((5, 7), (3, 4)), ((1, 9), (6, 1)),
                                   ((33, 2), (2, 17))])
def test_out_of_range_yields_zero(hw, mn):
    """Any (H, W) and (M, N); an index outside the image gives 0.0, an
    index inside gives the pixel exactly."""
    h, w = hw
    rng = np.random.RandomState(h * w)
    img = rng.randn(h, w).astype(np.float32)
    y = rng.randint(-3, h + 3, mn).astype(np.int32)
    x = rng.randint(-3, w + 3, mn).astype(np.int32)
    y.flat[0], x.flat[0] = -1, 0            # one of each, whatever the draw
    y.flat[-1], x.flat[-1] = h - 1, w - 1
    got = gather2d(torch.from_numpy(img), torch.from_numpy(y),
                   torch.from_numpy(x)).numpy()
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    want = np.where(inside, img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)],
                    np.float32(0))
    np.testing.assert_array_equal(got, want)
    assert got.flat[0] == 0.0 and got.flat[-1] == img[-1, -1]
