"""The port's training entry ``python -m dvd_tpu_torch.cli.run_training`` on
the CPU: the device-resident dataset against ``run_training.py``'s (the
same batches in the same order, the image rounded where ``dvd_tpu``
truncates it), its size gate, a whole run on synthetic pages at the tiny
configuration, and the imports on a machine without cv2 and h5py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.config import default_config as j_default_config
from dvd_tpu_torch.cli import run_training as RT
from dvd_tpu_torch.config import default_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _RawSet:
    """Raw device-aug items at 512^2 whose flow carries the item's index:
    an image with fractional levels, a soft mask."""

    def __init__(self, n):
        self.samples = list(range(n))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i, seed=0):
        rng = np.random.RandomState(seed)
        return {"image512": (rng.rand(512, 512, 3) * 255).astype(np.float32),
                "doc_mask512": rng.rand(512, 512, 1).astype(np.float32),
                "flow_map": np.full((512, 512, 2), i, np.float32)}


def test_device_resident_iterator_draws_jax_batches():
    """Seven batches of 2 from 5 items (three epoch boundaries): the same
    items in the same order as ``run_training.device_resident_iterator``;
    the staged image is the item rounded to whole levels, the mask and
    the flow the item's f32 values."""
    import run_training as JRT

    ds = _RawSet(5)
    want = JRT.device_resident_iterator(
        j_default_config().replace(train={"batch_size": 2}), ds, seed=3)
    got = RT.device_resident_iterator(
        default_config().replace(train={"batch_size": 2}), ds, seed=3,
        device="cpu")
    items = {i: ds.__getitem__(i, 3 * 100003 + i) for i in range(5)}
    for _ in range(7):
        g, w = next(got), next(want)
        idx = g["flow_map"][:, 0, 0, 0].long().tolist()
        np.testing.assert_array_equal(g["flow_map"].numpy(),
                                      np.asarray(w["flow_map"]))
        assert g["image512"].dtype == torch.float32
        for b, i in enumerate(idx):
            np.testing.assert_array_equal(
                g["image512"][b].numpy(), np.rint(items[i]["image512"]))
            np.testing.assert_array_equal(g["doc_mask512"][b].numpy(),
                                          items[i]["doc_mask512"])


def test_device_dataset_gate():
    """"off" never stages, "auto" stages what fits
    ``device_dataset_max_gb``, "on" stages or raises."""
    ds = _RawSet(10)          # 10 x 512^2 x 15 bytes = 39.3 MB

    def ok(mode, gb):
        return RT._device_dataset_ok(default_config().replace(
            train={"device_dataset": mode, "device_dataset_max_gb": gb}), ds)

    assert ok("auto", 0.04) and ok("on", 0.04)
    assert not ok("auto", 0.039) and not ok("off", 4.0)
    with pytest.raises(ValueError, match="device_dataset=on"):
        ok("on", 0.039)


TINY = ["model.dit_variant='DiT-mini'", "model.image_size=16",
        "model.source_size=128", "model.perception_size=64",
        "model.compute_dtype='float32'", "train.batch_size=2"]


@pytest.mark.parametrize("device_dataset", ["auto", "off"])
def test_main_trains_on_synthetic_pages(tmp_path, device_dataset, capsys):
    """``--synthetic 3`` (two training pages after the 0.97 split) at the
    tiny configuration on the CPU, with the shipped on-device
    augmentation: from the device-resident set, and from the host loader
    (``PrefetchLoader``); a train state and an EMA snapshot written."""
    sets = TINY + [
        f"paths.workspace_dir='{tmp_path / 'ws'}'",
        f"data.data_root='{tmp_path / 'data'}'",
        f"train.device_dataset='{device_dataset}'", "data.n_threads=2"]
    argv = ["--synthetic", "3", "--max_steps", "2", "--device", "cpu"]
    for kv in sets:
        argv += ["--set", kv]
    RT.main(argv)
    out = capsys.readouterr().out
    assert ("device-resident dataset: 2 samples" in out) == \
        (device_dataset == "auto")
    run = tmp_path / "ws" / "default"
    assert sorted(os.listdir(run)) == ["ema_0.9999_000002.msgpack",
                                       "state_00000002.pt"]
    assert len(os.listdir(tmp_path / "data" / "synthetic")) == 4


def test_multihost_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        RT.main(["--multihost", "--synthetic", "1"])


def test_imports_without_cv2_and_h5py(tmp_path):
    """Where cv2 and h5py are missing (the card's machine), the CLI and the
    data modules import, and a call that reads a file raises."""
    code = """
import sys
sys.modules["cv2"] = sys.modules["h5py"] = None
import dvd_tpu_torch.cli.run_training
import dvd_tpu_torch.data.doc3d as doc3d
import dvd_tpu_torch.data.synthetic as synthetic
import dvd_tpu_torch.data.doc_npz as doc_npz
for call in (lambda: doc3d.load_bm_mat("bm.mat"),
             lambda: doc3d.load_sample("i.png", "bm.mat", "r.png"),
             lambda: doc_npz.load_sample_npz("i.png", "bm.npz", "r.png"),
             lambda: synthetic.make_synthetic_sample(448, 0),
             lambda: synthetic.write_synthetic_doc3d(sys.argv[1], 1)):
    try:
        call()
    except RuntimeError as exc:
        print("raised:", exc)
    else:
        raise SystemExit("no error")
"""
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert len(lines) == 5 and all("required" in x for x in lines), lines
    assert any("h5py" in x for x in lines) and any("cv2" in x for x in lines)


def test_segments_chain_children(tmp_path, monkeypatch):
    """``--segment_steps``: children of at most K steps, each resuming from
    the latest ``state_*.pt``, with a new loader seed per segment and the
    parent's flags, until ``--max_steps``; a child that makes no progress
    stops the chain."""
    ws = tmp_path / "ws" / "default"
    calls = []

    def child(argv):
        calls.append(argv)
        ws.mkdir(parents=True, exist_ok=True)
        step = int(argv[argv.index("--max_steps") + 1])
        (ws / f"state_{step:08d}.pt").write_bytes(b"")
        return 0

    monkeypatch.setattr(RT.subprocess, "call", child)
    RT.main(["--segment_steps", "2", "--max_steps", "5", "--seed", "7",
             "--device", "cpu", "--set", f"paths.workspace_dir='{ws.parent}'"])
    assert [c[c.index("--max_steps") + 1] for c in calls] == ["2", "4", "5"]
    assert [c[c.index("--loader_seed") + 1] for c in calls] == \
        ["7", str(7 + 9973), str(7 + 2 * 9973)]
    assert all(c[1:3] == ["-m", "dvd_tpu_torch.cli.run_training"]
               and c[c.index("--device") + 1] == "cpu" for c in calls)
    monkeypatch.setattr(RT.subprocess, "call", lambda argv: 1)
    with pytest.raises(SystemExit, match="no checkpoint progress"):
        RT.main(["--segment_steps", "2", "--max_steps", "9",
                 "--set", f"paths.workspace_dir='{ws.parent}'"])
