"""The dataset driver's pinned, asynchronous copies on the card
(``dvd_tpu_torch/evaluation/driver.py:run_benchmark``): over five batches
of stand-in pages at mixed sizes, the last one partial, with coordinate
maps saved, its pages and maps equal bit for bit those of a plain
synchronous loop (upload, ``dewarp_flow``, ``unwarp_u8``, ``.cpu()`` per
batch, the same x_T generators); so they do under a writer that sleeps
50 ms before it reads each page, so that no pinned block is handed out
again while a writer holds a view of it, and fewer than
``WRITE_BACKLOG`` batches' writes are pending when one is queued (the
bound on the pinned blocks the writers hold); and every drain span says,
as a bool, whether its pull was done when it began.  Every test is marked
``cuda`` and skips without a card; the file imports neither JAX nor
``dvd_tpu``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_driver_cuda.py

The CPU path's spans are held in ``tests/test_torch_trace.py``.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from dvd_tpu_torch.config import default_config
from dvd_tpu_torch.evaluation import driver
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
from dvd_tpu_torch.utils import trace
from writer_pool import CountingPool

pytestmark = pytest.mark.cuda
BATCH = 4
CANVAS = 640
N_PAGES = 4 * BATCH + 2         # five batches, the last one partial
SEED = 3


class Pages:
    """``run_benchmark``'s dataset contract over ``n`` random pages of
    mixed sizes in a ``CANVAS``^2 canvas, the last batch padded by
    repeating its last page, as ``BenchmarkDataset`` pads it."""

    def __init__(self, n: int, size: int):
        rng = np.random.RandomState(0)
        self.pages = [rng.randint(0, 256, (300 + 37 * (i % 5),
                                           640 - 41 * (i % 4), 3))
                      .astype(np.uint8) for i in range(n)]
        self.sources = [rng.rand(size, size, 3).astype(np.float32)
                        for _ in range(n)]

    def __len__(self):
        return len(self.pages)

    def batches(self, batch_size: int):
        for start in range(0, len(self), batch_size):
            idx = list(range(start, min(start + batch_size, len(self))))
            count = len(idx)
            idx += [idx[-1]] * (batch_size - count)
            padded = np.zeros((batch_size, CANVAS, CANVAS, 3), np.uint8)
            for j, i in enumerate(idx):
                h, w = self.pages[i].shape[:2]
                padded[j, :h, :w] = self.pages[i]
            yield {"source_image": np.stack([self.sources[i] for i in idx]),
                   "source_padded": padded,
                   "hw": np.array([self.pages[i].shape[:2] for i in idx],
                                  np.int32),
                   "paths": [f"page_{i:03d}.png" for i in idx],
                   "count": count}


@pytest.fixture(scope="module")
def pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pinned copies run on the card)")
    cfg = default_config().replace(model={"dit_variant": "DiT-mini"})
    return DewarpPipeline.create(cfg, "cuda",
                                 generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def dataset(pipe):
    return Pages(N_PAGES, pipe.cfg.model.source_size)


@pytest.fixture(scope="module")
def plain(pipe, dataset):
    """Pages and coordinate maps by name from the plain synchronous
    loop."""
    dev = torch.device("cuda")
    pages, maps = {}, {}
    with torch.inference_mode():
        for bi, batch in enumerate(dataset.batches(BATCH)):
            src_u8 = np.clip(batch["source_image"] * 255.0 + 0.5, 0, 255)
            src = torch.from_numpy(src_u8.astype(np.uint8)).to(dev) \
                .to(torch.float32) / 255.0
            padded = torch.from_numpy(batch["source_padded"]).to(dev)
            hw = torch.from_numpy(batch["hw"]).to(dev)
            flow = pipe.dewarp_flow(
                src, generator=driver.batch_generator(dev, SEED, bi))
            out = driver.unwarp_u8(padded, hw, flow).cpu().numpy()
            flow_np = flow.float().cpu().numpy()
            for j in range(batch["count"]):
                name = batch["paths"][j]
                h, w = batch["hw"][j]
                pages[name] = out[j, :h, :w].copy()
                maps[name] = flow_np[j].copy()
    assert len(pages) == N_PAGES
    return pages, maps


@pytest.mark.parametrize("delay", [0.0, 0.05])
def test_pages_and_maps_equal_the_plain_loop(pipe, dataset, plain, tmp_path,
                                             monkeypatch, delay):
    """``delay``: seconds each write sleeps before it reads its page."""
    got, lock = {}, threading.Lock()

    def keep(path, arr):
        if delay:
            time.sleep(delay)
        with lock:
            got[os.path.basename(path)] = np.array(arr, copy=True)

    monkeypatch.setattr(driver, "save_png", keep)
    monkeypatch.setattr(CountingPool, "most", 0)
    monkeypatch.setattr(driver, "ThreadPoolExecutor", CountingPool)
    trace.clear()
    trace.enable()
    try:
        stats = driver.run_benchmark(pipe, dataset, str(tmp_path),
                                     batch_size=BATCH, seed=SEED,
                                     save_coord_maps=True, mesh=None)
    finally:
        trace.disable()
    drains = [r[5] for r in trace.records() if r[0] == "dvd.driver.drain"]
    trace.clear()
    assert stats["images"] == N_PAGES
    pages, maps = plain
    assert sorted(got) == sorted(f"warped_{n}" for n in pages)
    pred = tmp_path / "dewarped_pred"
    for name, page in pages.items():
        np.testing.assert_array_equal(got[f"warped_{name}"], page,
                                      err_msg=name)
        np.testing.assert_array_equal(np.load(pred / f"coord_{name}.npy"),
                                      maps[name], err_msg=name)
    assert [d["batch"] for d in drains] == list(range(len(drains)))
    assert len(drains) == -(-N_PAGES // BATCH)
    assert all(type(d["ready"]) is bool for d in drains)
    # a page and a coordinate map a page
    assert CountingPool.most < driver.WRITE_BACKLOG * 2 * BATCH
