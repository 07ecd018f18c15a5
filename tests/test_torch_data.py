"""The training data pipeline of ``dvd_tpu_torch`` against ``dvd_tpu``'s on
the CPU: the synthetic page generator, the Doc3D and warped_BM.npz
datasets (both ``device_aug`` modes) and the prefetching loader.

The port runs the same numpy, OpenCV and h5py code, so every item, page
and file is held to ``dvd_tpu``'s bit for bit.
"""

import json
import threading
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from dvd_tpu.data import doc3d as jdoc3d  # noqa: E402
from dvd_tpu.data import doc_npz as jnpz  # noqa: E402
from dvd_tpu.data import loader as jloader  # noqa: E402
from dvd_tpu.data import synthetic as jsyn  # noqa: E402
from dvd_tpu.evaluation import calibrate as jcal  # noqa: E402
from dvd_tpu_torch.data import doc3d, doc_npz, loader, synthetic  # noqa: E402
from dvd_tpu_torch.evaluation import calibrate  # noqa: E402


def _assert_items_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def doc3d_root(tmp_path_factory):
    """Three synthetic Doc3D samples written by the port, and a texture."""
    root = str(tmp_path_factory.mktemp("doc3d"))
    synthetic.write_synthetic_doc3d(root, 3, seed=4)
    tex = str(tmp_path_factory.mktemp("tex") / "tex.png")
    rng = np.random.RandomState(0)
    cv2.imwrite(tex, (rng.rand(60, 80, 3) * 255).astype(np.uint8))
    return root, tex


@pytest.mark.parametrize("seed", [0, 17])
def test_pages_match(seed):
    """``render_document``, ``oracle_registration_flow`` and
    ``make_synthetic_sample`` equal ``dvd_tpu``'s."""
    np.testing.assert_array_equal(calibrate.render_document(96, 80, seed),
                                  jcal.render_document(96, 80, seed))
    u = jcal.random_warp_field(64, 48, 6.0, seed)
    np.testing.assert_array_equal(calibrate.oracle_registration_flow(u),
                                  jcal.oracle_registration_flow(u))
    for got, want in zip(synthetic.make_synthetic_sample(448, seed),
                         jsyn.make_synthetic_sample(448, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_written_doc3d_matches(doc3d_root, tmp_path):
    """``write_synthetic_doc3d``'s files read back as ``dvd_tpu``'s do."""
    root, _ = doc3d_root
    jroot = jsyn.write_synthetic_doc3d(str(tmp_path), 1, seed=4)
    got = doc3d.make_doc3d_sample_list(root, split_ratio=1.0)
    want = jdoc3d.make_doc3d_sample_list(jroot, split_ratio=1.0)
    assert len(got) == 3 and len(want) == 1
    assert doc3d.make_doc3d_sample_list(root) == got[:2]
    for a, b in zip(doc3d.load_sample(*got[0]), jdoc3d.load_sample(*want[0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device_aug", [False, True])
def test_doc3d_items_match(doc3d_root, device_aug):
    """``Doc3DDataset.__getitem__(i, seed)`` equals ``dvd_tpu``'s, with a
    texture list (every background branch over the seeds) and with none;
    ``device_aug`` items carry the raw keys."""
    root, tex = doc3d_root
    samples = doc3d.make_doc3d_sample_list(root, split_ratio=1.0)
    for textures in ((), (tex,)):
        kw = dict(samples=samples, textures=textures, inter_t=7,
                  device_aug=device_aug)
        ds, jds = doc3d.Doc3DDataset(**kw), jdoc3d.Doc3DDataset(**kw)
        for i, seed in ((0, 1), (1, 2), (2, 5), (0, 9)):
            got = ds.__getitem__(i, seed)
            _assert_items_equal(got, jds.__getitem__(i, seed))
            assert ("image512" in got) == device_aug


@pytest.fixture(scope="module")
def npz_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("npz"))
    doc_npz.write_synthetic_doc_npz(root, 2, seed=3)
    return root


@pytest.mark.parametrize("family", ["doc_debug", "aug_doc", "aug_doc_device"])
def test_npz_items_match(npz_root, tmp_path, family):
    """``DocNpzDataset`` and ``AugDocNpzDataset`` (both ``device_aug``
    modes) equal ``dvd_tpu``'s on ``write_synthetic_doc_npz`` output, and
    the written files equal ``dvd_tpu``'s."""
    samples = doc_npz.make_doc_sample_list(npz_root, split_ratio=1.0)
    assert samples == jnpz.make_doc_sample_list(npz_root, split_ratio=1.0)
    if family == "doc_debug":
        ds, jds = doc_npz.DocNpzDataset(samples), jnpz.DocNpzDataset(samples)
    else:
        kw = dict(device_aug=family.endswith("device"), inter_t=5)
        ds = doc_npz.AugDocNpzDataset(samples, **kw)
        jds = jnpz.AugDocNpzDataset(samples, **kw)
    for i, seed in ((0, 3), (1, 8)):
        _assert_items_equal(ds.__getitem__(i, seed), jds.__getitem__(i, seed))
    jroot = jnpz.write_synthetic_doc_npz(str(tmp_path), 1, seed=3)
    jsample = jnpz.make_doc_sample_list(jroot, split_ratio=1.0)[0]
    np.testing.assert_array_equal(doc_npz.load_bm_npz(samples[0][1]),
                                  jnpz.load_bm_npz(jsample[1]))
    for a, b in zip(doc_npz.load_sample_npz(*samples[0]),
                    jnpz.load_sample_npz(*jsample)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_manifest_regenerates_on_seed_change(tmp_path):
    """A rerun with the same seed keeps the samples; another seed replaces
    them and records itself in the manifest."""
    root = str(tmp_path / "syn")
    synthetic.write_synthetic_doc3d(root, 1, seed=1)
    img1 = cv2.imread(f"{root}/syn_00000/img.png")
    synthetic.write_synthetic_doc3d(root, 1, seed=1)
    assert (cv2.imread(f"{root}/syn_00000/img.png") == img1).all()
    synthetic.write_synthetic_doc3d(root, 1, seed=2)
    assert not (cv2.imread(f"{root}/syn_00000/img.png") == img1).all()
    with open(f"{root}/synthetic_manifest.json") as f:
        assert json.load(f) == {"seed": 2, "size": 448}
    with pytest.raises(ValueError, match="448"):
        synthetic.write_synthetic_doc3d(root, 1, size=512)


class _Indexed:
    """Items that record their index and seed."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i, seed=0):
        if i == self.fail_at:
            raise IOError(f"unreadable sample {i}")
        return {"i": np.int64(i), "seed": np.int64(seed)}


@pytest.mark.parametrize("shuffle", [False, True])
def test_prefetch_loader_order_matches(shuffle):
    """Batches, their order over three epochs and the per-item seeds equal
    ``dvd_tpu``'s PrefetchLoader's, with and without shuffling; a
    strided process slice takes every other item."""
    def first(ld, n):
        it = iter(ld)
        out = [next(it) for _ in range(n)]
        it.close()
        return out

    for kw in (dict(), dict(process_index=1, process_count=2)):
        args = dict(batch_size=3, num_workers=2, seed=5, shuffle=shuffle, **kw)
        got = first(loader.PrefetchLoader(_Indexed(10), **args), 6)
        want = first(jloader.PrefetchLoader(_Indexed(10), **args), 6)
        for a, b in zip(got, want):
            _assert_items_equal(a, b)
    if not shuffle:
        # drop_last: one batch of the five odd items per epoch
        assert [list(b["i"]) for b in got[:2]] == [[1, 3, 5], [1, 3, 5]]


def test_prefetch_loader_raises_errors():
    """An item that fails to load ends the iteration with its exception,
    after the batches before it (``dvd_tpu``'s loader hangs instead)."""
    it = iter(loader.PrefetchLoader(_Indexed(9, fail_at=4), batch_size=2,
                                    num_workers=2, shuffle=False))
    assert [list(next(it)["i"]) for _ in range(2)] == [[0, 1], [2, 3]]
    with pytest.raises(IOError, match="unreadable sample 4"):
        next(it)


def test_prefetch_loader_terminates():
    """Closing the iterator stops its producer thread (with a full queue
    waiting), and a slice smaller than a batch is refused."""
    before = set(threading.enumerate())
    it = iter(loader.PrefetchLoader(_Indexed(40), batch_size=2, depth=1,
                                    num_workers=2))
    next(it)
    time.sleep(0.2)               # the producer fills the queue and waits
    it.close()
    deadline = time.time() + 10
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before
    with pytest.raises(ValueError, match="samples < batch_size"):
        loader.PrefetchLoader(_Indexed(6), batch_size=10)
    with pytest.raises(ValueError, match="samples < batch_size"):
        loader.PrefetchLoader(_Indexed(12), batch_size=10, process_index=0,
                              process_count=2)
