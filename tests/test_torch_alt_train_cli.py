"""The alternative denoisers through the port's training entry point on the
CPU: two steps of ``cli/run_training --synthetic 3`` per drivable family
at the tiny configuration (``--set model.train_mode=... --set
model.train_VGG=False``; the shipped on-device augmentation from the
device-resident set), then the EMA snapshot it wrote served by
``run_sampling --image`` through ``paths.model_path`` (the weight file
loads into the family's denoiser, every key used).  What the step
computes is held to ``dvd_tpu`` in ``tests/test_torch_alt_train.py``.
"""

import os

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.cli import run_sampling
from dvd_tpu_torch.cli import run_training as RT

TINY = ["model.image_size=16", "model.source_size=128",
        "model.perception_size=64", "model.compute_dtype='float32'",
        "model.train_VGG=False", "model.num_channels=32",
        "model.num_res_blocks=1", "model.num_heads=2",
        "model.attention_resolutions='8,4'"]


@pytest.mark.parametrize("mode", ["stage_1", "stage_1_transformer",
                                  "stage_1_doctr"])
def test_train_then_serve(mode, tmp_path, monkeypatch, capsys):
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    sets = TINY + [f"model.train_mode='{mode}'", "train.batch_size=2",
                   f"paths.workspace_dir='{tmp_path / 'ws'}'",
                   f"data.data_root='{tmp_path / 'data'}'"]
    argv = ["--synthetic", "3", "--max_steps", "2", "--device", "cpu"]
    for kv in sets:
        argv += ["--set", kv]
    RT.main(argv)
    assert "device-resident dataset: 2 samples" in capsys.readouterr().out
    run = tmp_path / "ws" / "default"
    assert sorted(os.listdir(run)) == ["ema_0.9999_000002.msgpack",
                                       "state_00000002.pt"]

    page = tmp_path / "page.png"
    rng = np.random.RandomState(0)
    Image.fromarray((rng.rand(45, 60, 3) * 255).astype(np.uint8)).save(page)
    argv = ["--image", str(page), "--out", str(tmp_path / "out.png"),
            "--device", "cpu", "--set",
            f"paths.model_path='{run / 'ema_0.9999_000002.msgpack'}'"]
    for kv in TINY + [f"model.train_mode='{mode}'"]:
        argv += ["--set", kv]
    run_sampling.main(argv)
    assert "'dit_vars': True" in capsys.readouterr().out
    flow = np.load(str(tmp_path / "out.png") + ".coords.npy")
    assert flow.shape == (16, 16, 2) and np.isfinite(flow).all()
    assert np.abs(flow).max() <= 1
