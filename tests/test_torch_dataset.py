"""The dataset serving path of the port against ``dvd_tpu`` on the CPU:
``unwarp_native`` (pages of different sizes in one canvas), the driver's
uint8 transform, ``BenchmarkDataset``'s items and batches, and the
CLI's ``--eval_dataset`` layout."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.data.benchmark import BenchmarkDataset as JDataset
from dvd_tpu.evaluation.pipeline import unwarp_native as j_unwarp_native
from dvd_tpu_torch.cli import run_sampling
from dvd_tpu_torch.data import benchmark
from dvd_tpu_torch.data.benchmark import BenchmarkDataset
from dvd_tpu_torch.evaluation.driver import unwarp_u8
from dvd_tpu_torch.evaluation.pipeline import native_grid, unwarp_native
from test_torch_common import t


def _canvas(seed, p, hws, dtype=np.float32):
    rng = np.random.RandomState(seed)
    pad = np.zeros((len(hws), p, p, 3), dtype)
    for i, (h, w) in enumerate(hws):
        img = rng.rand(h, w, 3)
        pad[i, :h, :w] = img if dtype == np.float32 else np.round(img * 255)
    flow = ((rng.rand(len(hws), 16, 16, 2) - 0.5) * 0.2).astype(np.float32)
    return pad, np.array(hws, np.int32), flow


@pytest.mark.parametrize("p,hws", [(96, [(70, 90), (96, 41)]),
                                   (128, [(128, 128), (33, 100), (77, 5)])])
def test_unwarp_native_matches_dvd_tpu(p, hws):
    """f32 on [0, 1], each page's valid region (beyond (h, w) is
    don't-care), <= 1e-4; and the coordinates themselves."""
    pad, hw, flow = _canvas(p, p, hws)
    want = np.asarray(j_unwarp_native(jnp.asarray(pad), jnp.asarray(hw),
                                      jnp.asarray(flow)))
    got = unwarp_native(t(pad), torch.from_numpy(hw), t(flow))
    assert got.shape == pad.shape and got.dtype == torch.float32
    for i, (h, w) in enumerate(hws):
        np.testing.assert_allclose(got[i, :h, :w].numpy(), want[i, :h, :w],
                                   atol=1e-4)
    # a bf16 flow is cast to f32 first
    bf = t(flow).to(torch.bfloat16)
    got16 = unwarp_native(t(pad), torch.from_numpy(hw), bf)
    want16 = unwarp_native(t(pad), torch.from_numpy(hw), bf.float())
    assert torch.equal(got16, want16)
    px, py = native_grid(torch.from_numpy(hw), t(flow), p)
    assert px.shape == py.shape == (len(hws), p, p)
    assert px.dtype == torch.float32


def test_driver_uint8_transform_matches_dvd_tpu():
    """uint8 canvas in, uint8 out: round half to even, clip, cast, as
    dvd_tpu's driver; equal but where the two unwarps straddle a .5 tie,
    and never more than one level apart."""
    hws = [(90, 120), (128, 61)]
    pad, hw, flow = _canvas(3, 128, hws, np.uint8)
    want = np.asarray(jnp.clip(jnp.round(j_unwarp_native(
        jnp.asarray(pad).astype(jnp.float32), jnp.asarray(hw),
        jnp.asarray(flow))), 0.0, 255.0).astype(jnp.uint8))
    got = unwarp_u8(torch.from_numpy(pad), torch.from_numpy(hw),
                    t(flow)).numpy()
    assert got.dtype == np.uint8 and got.shape == pad.shape
    f32 = unwarp_native(t(pad.astype(np.float32)), torch.from_numpy(hw),
                        t(flow)).numpy()
    for i, (h, w) in enumerate(hws):
        diff = np.abs(got[i, :h, :w].astype(int) - want[i, :h, :w])
        assert diff.max() <= 1
        near_tie = np.abs(f32[i, :h, :w] - np.floor(f32[i, :h, :w]) - 0.5) \
            < 1e-3
        assert (diff[~near_tie] == 0).all()
    assert np.round(np.float32(2.5)) == 2.0 and \
        torch.round(torch.tensor(2.5)) == 2.0   # half to even on both


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Six PNGs of mixed sizes (sides up to 300: the fit canvas is 512)
    and one JPEG."""
    d = tmp_path_factory.mktemp("pages")
    rng = np.random.RandomState(0)
    for i in range(6):
        h, w = 96 + 8 * (i % 3), 120 + 90 * (i % 3)
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img_{i}.png")
    Image.fromarray((rng.rand(40, 50, 3) * 255).astype(np.uint8)).save(
        d / "sub.jpg")
    return str(d)


@pytest.mark.parametrize("kw", [dict(source_size=128),
                                dict(source_size=64, pad_to=256),
                                dict(source_size=64, max_side=200)])
def test_benchmark_dataset_matches_dvd_tpu(image_dir, kw):
    """Same paths, canvas, items and batches (the last one padded by
    repeating its last item), exactly."""
    ds, jds = BenchmarkDataset.from_dir(image_dir, **kw), \
        JDataset.from_dir(image_dir, **kw)
    assert ds.paths == jds.paths and len(ds) == len(jds) == 7
    assert ds.pad_to == jds.pad_to
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert a.keys() == b.keys() and a["path"] == b["path"]
        for k in ("source_image", "source_padded", "hw"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    got, want = list(ds.batches(4)), list(jds.batches(4))
    assert [b["count"] for b in got] == [b["count"] for b in want] == [4, 3]
    for a, b in zip(got, want):
        assert a["paths"] == b["paths"]
        for k in ("source_image", "source_padded", "hw"):
            np.testing.assert_array_equal(a[k], b[k])
    last = got[-1]
    assert last["paths"][2] == last["paths"][3]
    np.testing.assert_array_equal(last["source_padded"][3],
                                  last["source_padded"][2])


def test_benchmark_dataset_without_cv2(image_dir, monkeypatch):
    """As dvd_tpu's: reading an item without cv2 raises RuntimeError."""
    import sys

    ds = BenchmarkDataset.from_dir(image_dir, pad_to=256)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2 required"):
        ds[0]
    assert benchmark.list_benchmark_images(image_dir) == ds.paths


TINY_SET = ["model.image_size=16", "model.source_size=128",
            "model.perception_size=64", "model.compute_dtype='float32'",
            "model.dit_variant='DiT-mini'", "diffusion.n_batch=2"]


def test_cli_eval_dataset_writes_the_reference_layout(image_dir, tmp_path,
                                                      monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--eval_dataset", image_dir, "--eval_dataset_name", "tiny",
            "--name", "run1", "--batch", "4", "--device", "cpu",
            "--profile", str(tmp_path / "trace"),
            "--set", f"paths.model_path={tmp_path / 'none.pt'}"]
    for s in TINY_SET:
        argv += ["--set", s]
    run_sampling.main(argv)
    out = tmp_path / "vis_hp" / "tiny" / "run1"
    names = sorted(os.listdir(out / "dewarped_pred"))
    assert names == sorted(f"warped_{os.path.basename(p)}"
                           for p in BenchmarkDataset.from_dir(
                               image_dir, pad_to=256).paths)
    for n in names:
        with Image.open(out / "dewarped_pred" / n) as im:
            src = Image.open(os.path.join(image_dir, n[len("warped_"):]))
            assert im.size == src.size and im.mode == "RGB"
    stats = json.loads((out / "run_stats.json").read_text())
    assert stats["images"] == 7
    assert set(stats) == {"images", "seconds_total", "imgs_per_sec",
                          "compile_seconds", "stage_seconds_per_batch"}
    printed = capsys.readouterr().out
    assert "'dit_vars': False" in printed and "7 images" in printed
    # --profile: a torch.profiler trace of the steady state (the
    # second batch)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_cli_corruption_raises():
    """The sweep is ported (tests/test_torch_corruptions.py); an unknown
    corruption id raises before any pipeline is built."""
    with pytest.raises(SystemExit, match="valid"):
        run_sampling.main(["--eval_dataset", "x", "--corruption", "rain",
                           "--device", "cpu"])
