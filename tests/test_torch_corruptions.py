"""The robustness sweep of ``dvd_tpu_torch`` against ``dvd_tpu``'s on the
CPU: every corruption at every severity equal to ``dvd_tpu``'s bit for
bit, and ``run_sampling --corruption`` over a 3-page directory writing
the per-combination outputs that ``dvd_tpu``'s sweep names, from the
same corrupted items.
"""

import json
import os

import numpy as np
import pytest

import run_sampling as j_run_sampling
import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.data import corruptions as jcorr
from dvd_tpu_torch.cli import run_sampling
from dvd_tpu_torch.data import corruptions
from dvd_tpu_torch.data.benchmark import BenchmarkDataset


class _PtpArray(np.ndarray):
    """An ndarray with NumPy 1's ``ptp`` method, which ``dvd_tpu``'s
    ``frost`` calls and NumPy 2 removed."""

    def ptp(self, *args, **kwargs):
        return np.ptp(np.asarray(self), *args, **kwargs)


def _page(h=40, w=52, seed=0):
    rng = np.random.RandomState(seed)
    img = 0.7 + 0.2 * rng.rand(h, w, 3)
    img[::6] *= 0.3                                   # text-like rows
    return img.astype(np.float32)


def _reference(name, img, sev, monkeypatch):
    """dvd_tpu's ``corrupt``; its ``frost`` reads ``ptp`` from a blurred
    array that has the method (NumPy 2 removed it)."""
    if name == "frost":
        blur = jcorr.cv2.GaussianBlur

        class Cv2:
            def __getattr__(self, attr):
                return getattr(jcorr.cv2, attr)

            @staticmethod
            def GaussianBlur(*a, **k):
                return blur(*a, **k).view(_PtpArray)

        monkeypatch.setattr(jcorr, "cv2", Cv2())
    return np.asarray(jcorr.corrupt(img, name, sev))


def test_every_corruption_is_listed():
    assert sorted(corruptions.CORRUPTIONS) == sorted(jcorr.CORRUPTIONS)
    assert len(corruptions.CORRUPTIONS) == 15
    assert set(corruptions.NEEDS_CV2) < set(corruptions.CORRUPTIONS)


@pytest.mark.parametrize("name", sorted(jcorr.CORRUPTIONS))
def test_corruption_equals_dvd_tpu(name, monkeypatch):
    """Severities 1-5 on two pages, bit for bit."""
    for seed in (0, 1):
        img = _page(seed=seed)
        for sev in range(1, 6):
            want = _reference(name, img, sev, monkeypatch)
            got = corruptions.corrupt(img, name, sev)
            assert got.dtype == np.float32 and got.shape == img.shape
            np.testing.assert_array_equal(got, want, err_msg=f"s{sev}")


def test_corrupt_refuses_unknown_names_and_severities():
    img = _page()
    with pytest.raises(KeyError):
        corruptions.corrupt(img, "rain", 1)
    with pytest.raises(ValueError):
        corruptions.corrupt(img, "fog", 6)
    assert corruptions.corruption_names("all") == sorted(jcorr.CORRUPTIONS)
    assert corruptions.corruption_names("fog") == ["fog"]
    with pytest.raises(SystemExit, match="rain"):
        corruptions.corruption_names("rain")


def _write_pages(root, sizes=((60, 50), (44, 70), (52, 52))):
    import cv2

    os.makedirs(root, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        img = (_page(h, w, seed=10 + i) * 255).round().astype(np.uint8)
        cv2.imwrite(os.path.join(root, f"{i + 1}_1.png"), img[:, :, ::-1])
    return root


TINY = ["--set", "model.dit_variant=DiT-mini", "--set",
        "model.image_size=16", "--set", "model.source_size=128", "--set",
        "model.perception_size=64", "--set", "model.compute_dtype=float32"]


def test_sweep_matches_dvd_tpu_outputs(tmp_path, monkeypatch):
    """``run_sampling --corruption gaussian_noise --device cpu`` over a
    3-page directory at the tiny size: per severity, the directory and
    files ``dvd_tpu``'s sweep writes (its ``run_benchmark`` recorded, not
    run), and items equal to its corrupted ones."""
    from dvd_tpu.evaluation import driver as jdriver
    from dvd_tpu.evaluation import pipeline as jpipeline
    from dvd_tpu.training import checkpoint as jckpt

    pages = _write_pages(str(tmp_path / "pages"))
    monkeypatch.chdir(tmp_path)
    argv = ["--eval_dataset", pages, "--eval_dataset_name", "tiny",
            "--name", "x", "--batch", "2", "--corruption", "gaussian_noise"]
    recorded = {}

    def record(pipe, ds, out_dir, **kw):
        recorded[out_dir] = ds
        return {"images": len(ds), "imgs_per_sec": 0.0}

    monkeypatch.setattr(jdriver, "run_benchmark", record)
    monkeypatch.setattr(jpipeline.DewarpPipeline, "create",
                        classmethod(lambda cls, cfg, rng=None: None))
    monkeypatch.setattr(jckpt, "maybe_load_pipeline_weights",
                        lambda pipe, cfg: {})
    j_run_sampling.main(argv)

    run_sampling.main(argv + TINY + ["--device", "cpu"])
    want_dirs = sorted(recorded)
    assert want_dirs == [os.path.join("vis_hp", "tiny",
                                      f"x_corrupt_gaussian_noise_s{s}")
                         for s in range(1, 6)]
    base = BenchmarkDataset.from_dir(     # at dvd_tpu's run's source size
        pages, source_size=recorded[want_dirs[0]].source_size)
    names = sorted(f"warped_{i}_1.png" for i in (1, 2, 3))
    for out_dir in want_dirs:
        sev = int(out_dir[-1])
        assert sorted(os.listdir(os.path.join(out_dir, "dewarped_pred"))) \
            == names
        with open(os.path.join(out_dir, "run_stats.json")) as f:
            assert json.load(f)["images"] == 3
        jds = recorded[out_dir]
        mine = corruptions.CorruptedDataset(base, "gaussian_noise", sev)
        assert len(mine) == len(jds) == 3
        for i in range(3):
            got, want = mine[i], jds[i]
            for key in ("source_image", "source_padded", "hw"):
                np.testing.assert_array_equal(got[key], want[key])
        got, want = (next(d.batches(2)) for d in (mine, jds))
        np.testing.assert_array_equal(got["source_padded"],
                                      want["source_padded"])
