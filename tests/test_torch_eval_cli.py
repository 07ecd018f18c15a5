"""The scoring CLIs of ``dvd_tpu_torch`` (``cli/evaluate.py``,
``cli/benchmark.py``) against ``dvd_tpu``'s on the CPU: file pairing,
the ``adres`` tables of a tiny prediction/scan tree (OpenCV's DIS
registration, one worker), and ``python -m dvd_tpu_torch.cli.benchmark``
end to end at the tiny model size.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.cli import benchmark as jbench
from dvd_tpu.cli import evaluate as jevaluate
from dvd_tpu_torch.cli import benchmark, evaluate
from dvd_tpu_torch.evaluation import calibrate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AREA = 20000.0     # the protocol resize, small so DIS runs fast

NAMES = ["warped_12_1 copy.png", "12_2 copy_rec.png", "3_1.png", "3.png",
         "warped_img_7.png", "0_0_0_45_2_geo.jpg", "out512_3_1.png",
         "scan.png", "07.png", "warped_5_2_unwarp.png"]


@pytest.mark.filterwarnings("ignore:pair_key fallback")
def test_pair_key_and_leading_int_equal_dvd_tpu():
    for name in NAMES:
        assert benchmark.pair_key(name) == jbench.pair_key(name), name
        assert evaluate.leading_int(name) == jevaluate.leading_int(name), name
    assert benchmark.pair_key("warped_12_1 copy.png") == (12, 1)
    assert benchmark.pair_key("0_0_0_45_2_geo.jpg") == (45, 2)
    with pytest.warns(UserWarning, match="fallback"):
        assert benchmark.pair_key("out512_3_1.png") == (3, 1)


def _gray_rgb(g):
    return np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None], 3, -1)


def _tree(root, cats=("", )):
    """Scans ``gt[/cat]/{k}.png`` and warped predictions
    ``pred[/cat]/warped_{k}_{m} copy.png`` (cv2 writes BGR: grey pages
    read back the same)."""
    import cv2

    for c, cat in enumerate(cats):
        gt_dir = os.path.join(root, "gt", cat)
        pred_dir = os.path.join(root, "pred", cat)
        os.makedirs(gt_dir)
        os.makedirs(pred_dir)
        for k in (1, 2):
            scan = calibrate.render_document(96, 80, seed=20 * c + k)
            cv2.imwrite(os.path.join(gt_dir, f"{k}.png"), _gray_rgb(scan))
            for m in (1, 2):
                u = calibrate.random_warp_field(96, 80, 1.5 * m, seed=k + m)
                cv2.imwrite(os.path.join(pred_dir, f"warped_{k}_{m} copy.png"),
                            _gray_rgb(calibrate.apply_warp(scan, u)))
    return os.path.join(root, "pred"), os.path.join(root, "gt")


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_evaluate_predictions_equals_dvd_tpu(tmp_path):
    """The same adres.json and adres.txt as dvd_tpu's for four pairs."""
    pred, gt = _tree(str(tmp_path / "a"))
    jpred = str(tmp_path / "jpred")
    shutil.copytree(pred, jpred)
    kw = dict(area=AREA, workers=1, flow_backend="dis")
    got = benchmark.evaluate_predictions(pred, gt, **kw)
    want = jbench.evaluate_predictions(jpred, gt, **kw)
    assert got == want and got["count"] == 4 and got["failed"] == 0
    assert _json(os.path.join(pred, "adres.json")) \
        == _json(os.path.join(jpred, "adres.json"))
    with open(os.path.join(pred, "adres.txt")) as f, \
            open(os.path.join(jpred, "adres.txt")) as g:
        assert f.read() == g.read()


def test_evaluate_categories_equals_dvd_tpu(tmp_path):
    """Per-category tables and adres_categories.json as dvd_tpu's, flat
    and in the sampling driver's nested layout."""
    pred, gt = _tree(str(tmp_path / "a"), cats=("book", "invoice"))
    jpred = str(tmp_path / "jpred")
    shutil.copytree(pred, jpred)
    kw = dict(area=AREA, workers=1, flow_backend="dis")
    got = benchmark.evaluate_categories(pred, gt, **kw)
    assert got == jbench.evaluate_categories(jpred, gt, **kw)
    assert _json(os.path.join(pred, "adres_categories.json")) \
        == _json(os.path.join(jpred, "adres_categories.json"))
    nested = str(tmp_path / "nested")
    for cat in ("book", "invoice"):
        shutil.copytree(os.path.join(pred, cat),
                        os.path.join(nested, cat, "dewarped_pred"))
    again = benchmark.evaluate_categories_nested(nested, gt, **kw)
    assert again["overall"] == got["overall"]
    assert os.path.isfile(os.path.join(nested, "adres_categories.json"))


def test_evaluate_cli_equals_dvd_tpu(tmp_path, capsys):
    pred, gt = _tree(str(tmp_path / "a"))
    args = ["--pred", pred, "--gt", gt, "--area", str(AREA), "--workers",
            "1", "--flow_backend", "dis"]
    evaluate.main(args + ["--out", str(tmp_path / "got.json")])
    jevaluate.main(args + ["--out", str(tmp_path / "want.json")])
    got = _json(tmp_path / "got.json")
    assert got == _json(tmp_path / "want.json") and got["count"] == 4


def test_benchmark_cli_end_to_end(tmp_path):
    """``python -m dvd_tpu_torch.cli.benchmark`` at the tiny size on the
    CPU: the photos are served (DiT-mini, weights from the seed), the
    outputs scored against the scans, and the adres table written."""
    import cv2

    pred, gt = _tree(str(tmp_path / "a"))
    photos = str(tmp_path / "photos")
    os.makedirs(photos)
    for name in sorted(os.listdir(pred)):
        shutil.copy(os.path.join(pred, name),
                    os.path.join(photos, name.replace("warped_", "")))
    cmd = [sys.executable, "-m", "dvd_tpu_torch.cli.benchmark",
           "--dataset", photos, "--gt", gt, "--name", "tiny_run",
           "--eval_dataset_name", "tiny", "--batch", "2", "--device", "cpu",
           "--workers", "1", "--flow_backend", "dis", "--area", str(AREA),
           "--set", "model.dit_variant=DiT-mini", "--set",
           "model.image_size=16", "--set", "model.source_size=128", "--set",
           "model.perception_size=64", "--set",
           "model.compute_dtype=float32"]
    # one thread: the suite runs several test workers on one host
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    pred_dir = tmp_path / "vis_hp" / "tiny" / "tiny_run" / "dewarped_pred"
    outputs = sorted(p for p in os.listdir(pred_dir) if p.endswith(".png"))
    assert outputs == sorted(f"warped_{k}_{m} copy.png" for k in (1, 2)
                             for m in (1, 2))
    for name in outputs:
        assert cv2.imread(str(pred_dir / name)).shape == (96, 80, 3)
    table = np.loadtxt(pred_dir / "adres.txt")
    summary = _json(pred_dir / "adres.json")
    assert table.shape == (5, 5) and summary["count"] == 4
    assert summary["failed"] == 0
    assert 0 < summary["ms_ssim"] <= 1 and summary["ld"] >= 0
    assert "imgs/sec" in out.stdout
