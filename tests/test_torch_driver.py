"""The port's batched driver (``evaluation/driver.py:run_benchmark``)
against ``dvd_tpu``'s on the CPU: the same tiny pipeline weights, the
same six pages of mixed sizes at batch 4 (the last batch padded), x_T
pinned in every sampling call on both sides (the stage-timing re-runs
call it again).  Coordinate maps <= 1e-4, PNGs <= 1 grey level, the same
``run_stats.json`` keys."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu.data.benchmark import BenchmarkDataset as JDataset
from dvd_tpu.evaluation import driver as jdriver
from dvd_tpu.evaluation.pipeline import DewarpPipeline as JPipeline
from dvd_tpu.models.dit import DiT as JDiT
from dvd_tpu.models.u2net import U2NetP as JU2NetP
from dvd_tpu.ops.resize import resize_bilinear as j_resize
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.data.benchmark import BenchmarkDataset
from dvd_tpu_torch.evaluation import driver
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.training.convert import load_variables
from test_torch_common import (MINI_DIT, S, SRC, TINY_MODEL, fill_zero_leaves,
                               mask_margin_shift, np_tree, port, t)

BATCH = 4


def _pages(d):
    """Six smooth pages (sinusoids over a gradient: a sub-pixel move of
    the sampling grid changes a pixel by far less than a grey level)."""
    rng = np.random.RandomState(0)
    for i in range(6):
        h, w = 90 + 16 * (i % 3), 120 + 20 * (i % 2)
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                             indexing="ij")
        ph = rng.rand(3) * 6
        img = np.stack([0.5 + 0.4 * np.sin(3 * xx + 2 * yy + p) for p in ph], -1)
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
            d / f"page_{i}.png")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("driver")
    (d / "pages").mkdir()
    _pages(d / "pages")
    cfg_over = dict(model=dict(TINY_MODEL, dit_variant="DiT-mini"),
                    diffusion={"n_batch": 2})

    jp = JPipeline.create(j_default_config().replace(**cfg_over))
    jp.dit = JDiT(tv=True, chain_blocks=False, **MINI_DIT)
    jp.init_params(jax.random.PRNGKey(0))
    jp.dit_vars = fill_zero_leaves(np_tree(jp.dit_vars), 11)
    seg = np_tree(jp.seg_vars)
    jds = JDataset.from_dir(str(d / "pages"), source_size=SRC)
    src = np.stack([jds[i]["source_image"] for i in range(len(jds))])
    d0 = JU2NetP(1).apply({"params": seg["params"]["msk"],
                           "batch_stats": seg["batch_stats"]["msk"]},
                          j_resize(jnp.asarray(src), (64, 64), True))[0]
    seg["params"]["msk"]["outconv"]["bias"] += mask_margin_shift(
        np.asarray(d0))
    jp.seg_vars = seg
    jp.line_vars, jp.geotr_vars = np_tree(jp.line_vars), np_tree(jp.geotr_vars)
    noise = np.random.RandomState(1).randn(2 * BATCH, S, S, 2) \
        .astype(np.float32)
    # pin x_T: the driver's jitted stages wrap the instance's sampling_impl
    jp.sampling_impl = functools.partial(JPipeline.sampling_impl, jp,
                                         init_noise=jnp.asarray(noise))
    jstats = jdriver.run_benchmark(jp, jds, str(d / "jax"), batch_size=BATCH,
                                   save_coord_maps=True)

    pipe = DewarpPipeline.create(default_config().replace(**cfg_over), "cpu")
    port(pipe.dit, jp.dit_vars)
    port(pipe.seg, jp.seg_vars)
    port(pipe.line, jp.line_vars)
    load_variables(pipe.geotr, jp.geotr_vars)
    sampling = pipe.sampling_impl
    pipe.sampling_impl = lambda cond, f, feat, gen=None: sampling(
        cond, f, feat, init_noise=t(noise))
    ds = BenchmarkDataset.from_dir(str(d / "pages"), source_size=SRC)
    stats = driver.run_benchmark(pipe, ds, str(d / "port"), batch_size=BATCH,
                                 save_coord_maps=True)
    return d, jds, stats, jstats


def test_outputs_match_dvd_tpu(runs):
    d, jds, _, _ = runs
    names = sorted(os.listdir(d / "jax" / "dewarped_pred"))
    assert names == sorted(os.listdir(d / "port" / "dewarped_pred"))
    assert len(names) == 12            # 6 PNGs + 6 coordinate maps
    for n in names:
        a = d / "port" / "dewarped_pred" / n
        b = d / "jax" / "dewarped_pred" / n
        if n.endswith(".npy"):
            want = np.load(b)
            assert np.abs(want).max() > 1e-2      # the DiT reached the output
            np.testing.assert_allclose(np.load(a), want, atol=1e-4)
        else:
            got, want = np.asarray(Image.open(a)), np.asarray(Image.open(b))
            src = np.asarray(Image.open(d / "pages" / n[len("warped_"):]))
            assert got.shape == want.shape == src.shape
            assert np.abs(got.astype(int) - want).max() <= 1


def test_run_stats_match_dvd_tpu(runs):
    d, jds, stats, jstats = runs
    on_disk = json.loads((d / "port" / "run_stats.json").read_text())
    assert on_disk == stats
    assert set(stats) == set(jstats)
    assert set(stats["stage_seconds_per_batch"]) == \
        set(jstats["stage_seconds_per_batch"])
    assert stats["images"] == jstats["images"] == len(jds) == 6
    assert stats["imgs_per_sec"] > 0 and stats["compile_seconds"] > 0
