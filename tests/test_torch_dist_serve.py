"""The port's batched driver over a 2-process gloo world on the CPU
(``evaluation/driver.py:run_benchmark(mesh=...)``): data-parallel serving
(data=2: each rank dewarps its half of every global batch, x_T drawn for
the global batch and sliced) and tensor-parallel serving (model=2: the DiT
and its SATRN decoder sharded, the aux nets whole) against one process
over the same pages, weights and seed: coordinate maps within
``tests/test_driver_sharded.py``'s 1e-5 (atol and rtol), PNGs within one
level; and the layout refused where it cannot be honoured.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.data.benchmark import BenchmarkDataset
from dvd_tpu_torch.evaluation.driver import run_benchmark
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.models.dit import DiT
from test_torch_common import S, TINY_MODEL, run_world
from test_torch_driver import _pages

DIT4 = dict(input_size=S, patch_size=2, hidden_size=48, depth=2,
            num_heads=4)
CFG = {"model": TINY_MODEL, "diffusion": {"n_batch": 2}}
BATCH = 4


def _compare(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 16
    for n in names:
        x, y = a / n, b / n
        if n.endswith(".npy"):
            np.testing.assert_allclose(np.load(x), np.load(y), atol=1e-5,
                                       rtol=1e-5)
        else:
            d = np.asarray(Image.open(x)).astype(int) - np.asarray(
                Image.open(y))
            assert np.abs(d).max() <= 1, n


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    (d / "pages").mkdir()
    _pages(d / "pages")
    for i in range(6, 8):          # 8 pages: two global batches of 4
        page = Image.open(d / "pages" / f"page_{i - 6}.png")
        page.transpose(Image.Transpose.FLIP_LEFT_RIGHT).save(
            d / "pages" / f"page_{i}.png")
    pipe = DewarpPipeline.create(
        default_config().replace(**CFG), "cpu",
        generator=torch.Generator().manual_seed(0),
        dit=DiT(dropout=0.0, **DIT4))
    weights = {n: getattr(pipe, n).state_dict()
               for n in ("dit", "seg", "line", "geotr")}
    ds = BenchmarkDataset.from_dir(str(d / "pages"), source_size=128)
    stats = run_benchmark(pipe, ds, str(d / "one"), batch_size=BATCH,
                          seed=3, save_coord_maps=True, mesh=None)
    assert stats["images"] == 8
    flow = np.load(d / "one" / "dewarped_pred" / "coord_page_0.png.npy")
    assert np.abs(flow).max() > 1e-2       # the DiT reached the output
    return d, weights


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["data2", "model2"])
def test_sharded_serving_matches_one_process(single, mesh, tmp_path):
    d, weights = single
    out = tmp_path / "run"
    w = run_world("serve", dict(
        cfg=CFG, dit=DIT4, weights=weights, pages=str(d / "pages"),
        out_dir=str(out), batch=BATCH, seed=3, mesh=mesh,
        probe="blocks_1.attn.qkv"), tmp_path)
    assert w["stats"]["images"] == 8
    assert json.loads((out / "run_stats.json").read_text())["images"] == 8
    assert w["probe"] == (("ColumnParallelLinear", (72, 48))
                          if mesh[1] == 2 else ("Linear", (144, 48)))
    _compare(out / "dewarped_pred", d / "one" / "dewarped_pred")


def test_serving_refuses_a_layout_it_cannot_hold(single):
    """``parallel.model_axis=2`` in one process: refused (the parent
    served unsharded and said nothing)."""
    d, _ = single
    pipe = DewarpPipeline.create(
        default_config().replace(**CFG, parallel={"model_axis": 2}), "cpu",
        dit=DiT(dropout=0.0, **DIT4))
    ds = BenchmarkDataset.from_dir(str(d / "pages"), source_size=128)
    with pytest.raises(AssertionError, match="not divisible by model=2"):
        run_benchmark(pipe, ds, str(d / "refused"), batch_size=BATCH)
