"""The scoring stack of ``dvd_tpu_torch`` against ``dvd_tpu``'s on the CPU:
MS-SSIM, SSIM, the protocol resize and ``evaluate_pair`` with OpenCV's
DIS bit for bit; the port's own SIFT-flow engine against the native
values of ``dvd_tpu``'s calibration snapshot
(``docs/registration_calibration.json``) and the cases of
``tests/test_native_siftflow.py``.

``dvd_tpu.native`` is never called here: another test worker may be
building its library at the same moment.
"""

import json
import os
import threading

import numpy as np
import pytest
import scipy.ndimage as ndi

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu.evaluation import calibrate as jcal
from dvd_tpu.evaluation import metrics as jmetrics
from dvd_tpu_torch import native
from dvd_tpu_torch.evaluation import calibrate, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _doc(h, w, seed):
    """A synthetic page (H, W, 3) in [0, 255] and a warped copy."""
    gt = calibrate.render_document(h, w, seed)
    u = calibrate.random_warp_field(h, w, 3.0, seed + 1)
    warped = calibrate.apply_warp(gt, u)
    return np.stack([gt] * 3, -1), np.stack([warped] * 3, -1)


def _textured(h=96, w=128, seed=0):
    rng = np.random.RandomState(seed)
    return ndi.gaussian_filter(rng.rand(h, w).astype(np.float32) * 255, 1.5)


# ------------------------------------------------ metrics vs dvd_tpu
@pytest.mark.parametrize("shape", [(197, 181), (180, 230, 3)])
def test_ssim_and_ms_ssim_equal_dvd_tpu(shape):
    rng = np.random.RandomState(len(shape))
    a = (rng.rand(*shape) * 255).astype(np.float32)
    b = np.clip(a + rng.randn(*shape) * 20, 0, 255).astype(np.float32)
    assert metrics.ssim_index(a, b) == jmetrics.ssim_index(a, b)
    assert metrics.ms_ssim(a, b) == jmetrics.ms_ssim(a, b)
    assert metrics.ms_ssim(a, a) == jmetrics.ms_ssim(a, a) == pytest.approx(1)


def test_resize_keep_ar_equals_dvd_tpu():
    img = (np.random.RandomState(2).rand(90, 61, 3) * 255).astype(np.uint8)
    for area in (598400.0, 3000.0):
        np.testing.assert_array_equal(metrics.resize_keep_ar(img, area),
                                      jmetrics.resize_keep_ar(img, area))


@pytest.mark.parametrize("area", [20000.0, None])
def test_evaluate_pair_dis_equals_dvd_tpu(area):
    """The DocUNet protocol with DIS registration: the same three numbers
    (with an area, both pages are resized; without, the rectified page is
    resized to its scan's size)."""
    gt, warped = _doc(150, 120, 3)
    rect = warped[5:-3, 2:-4] if area is None else warped
    got = metrics.evaluate_pair(rect, gt, protocol_area=area,
                                flow_backend="dis")
    want = jmetrics.evaluate_pair(rect, gt, protocol_area=area,
                                  flow_backend="dis")
    assert got == want
    np.testing.assert_array_equal(
        metrics.dense_registration_flow(warped, gt, "dis"),
        jmetrics.dense_registration_flow(warped, gt, "dis"))
    assert metrics.local_distortion(warped, gt, "dis") \
        == jmetrics.local_distortion(warped, gt, "dis")
    assert metrics.aligned_distortion(warped, gt, "dis") \
        == jmetrics.aligned_distortion(warped, gt, "dis")


def test_calibration_helpers_equal_dvd_tpu():
    u = calibrate.random_warp_field(48, 40, 4.0, 7)
    np.testing.assert_array_equal(u, jcal.random_warp_field(48, 40, 4.0, 7))
    gt = calibrate.render_document(48, 40, 5)
    np.testing.assert_array_equal(calibrate.apply_warp(gt, u),
                                  jcal.apply_warp(gt, u))
    v = calibrate.oracle_registration_flow(u)
    assert calibrate._ld_ad(v, gt) == jcal._ld_ad(v, gt)
    assert calibrate._spearman([1, 3, 2], [2, 9, 5]) \
        == jcal._spearman([1, 3, 2], [2, 9, 5]) == 1.0


def test_flow_to_image_equals_dvd_tpu(tmp_path):
    from dvd_tpu.evaluation import visualize as jvis
    from dvd_tpu_torch.evaluation import visualize

    flow = np.random.RandomState(4).randn(20, 30, 2).astype(np.float32)
    for clip in (None, 0.5):
        np.testing.assert_array_equal(visualize.flow_to_image(flow, clip),
                                      jvis.flow_to_image(flow, clip))
    img = (np.random.RandomState(5).rand(8, 9, 3) * 300).astype(np.float32)
    path = visualize.save_dewarped(str(tmp_path), "a.png", img)
    assert path == os.path.join(str(tmp_path), "dewarped_pred", "warped_a.png")
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  np.clip(img, 0, 255).astype(np.uint8))


# ------------------------------------------------- the native engine
CALIBRATION = os.path.join(REPO, "docs", "registration_calibration.json")


@pytest.mark.parametrize("row", [0, 5, 10])
def test_native_reproduces_the_calibration_snapshot(row):
    """One row of dvd_tpu's snapshot (640x512, warp magnitudes 2-16 px):
    the port's engine gives its ``ld_native`` / ``ad_native`` within 1e-9
    relative, and the oracle its ``ld_oracle`` / ``ad_oracle``."""
    with open(CALIBRATION) as f:
        snap = json.load(f)
    r = snap["rows"][row]
    h, w = snap["resolution"]
    mag, d = r["magnitude"], r["doc"]
    gt = calibrate.render_document(h, w, seed=100 + d)
    u = calibrate.random_warp_field(h, w, mag, seed=1000 + 10 * d + int(mag))
    warped = calibrate.apply_warp(gt, u)
    ld, ad = calibrate._ld_ad(native.sift_flow(gt, warped), gt)
    assert ld == pytest.approx(r["ld_native"], rel=1e-9, abs=0)
    assert ad == pytest.approx(r["ad_native"], rel=1e-9, abs=0)
    ld_o, ad_o = calibrate._ld_ad(calibrate.oracle_registration_flow(u), gt)
    assert ld_o == pytest.approx(r["ld_oracle"], rel=1e-9, abs=0)
    assert ad_o == pytest.approx(r["ad_oracle"], rel=1e-9, abs=0)


def test_native_recovers_integer_shift():
    a = _textured()
    dx, dy = 4, -3
    b = np.roll(np.roll(a, dy, axis=0), dx, axis=1)
    inner = native.sift_flow(a, b)[16:-16, 16:-16]
    assert float(np.median(inner[..., 0])) == pytest.approx(dx, abs=0.5)
    assert float(np.median(inner[..., 1])) == pytest.approx(dy, abs=0.5)


def test_native_identity_flow_is_zero_and_bad_shapes_raise():
    a = _textured(seed=1)
    assert float(np.abs(native.sift_flow(a, a)).mean()) < 0.05
    with pytest.raises(ValueError):
        native.sift_flow(a, a[:-2])


def test_native_smooth_warp_low_residual():
    a = _textured(128, 128, seed=2)
    ys, xs = np.meshgrid(np.arange(128.0), np.arange(128.0), indexing="ij")
    wob = 3.0 * np.sin(ys / 24.0)
    b = ndi.map_coordinates(a, [ys, xs + wob], order=1, mode="nearest")
    flow = native.sift_flow(a, b)
    err = np.abs(flow[16:-16, 16:-16, 0] + wob[16:-16, 16:-16])
    assert float(np.median(err)) < 1.5


def test_metrics_native_backend():
    a = _textured(120, 120, seed=3)
    rgb = np.stack([a, a, a], -1)
    assert metrics.local_distortion(rgb, rgb, backend="native") \
        == pytest.approx(0.0, abs=1e-3)
    shifted = np.roll(rgb, 5, axis=1)
    ld = metrics.local_distortion(shifted, rgb, backend="native")
    ad = metrics.aligned_distortion(shifted, rgb, backend="native")
    assert 3.0 < ld < 7.0
    assert ad < 0.6 * ld


def test_calibration_against_oracle_flow():
    """Both backends within 8% of the known registration flow on a warped
    page (the snapshot's full-size evidence, as a fast regression)."""
    gt = calibrate.render_document(320, 256, seed=11)
    u = calibrate.random_warp_field(320, 256, magnitude=5.0, seed=12)
    warped = calibrate.apply_warp(gt, u)
    ld_o, ad_o = calibrate._ld_ad(calibrate.oracle_registration_flow(u), gt)
    assert ld_o > 2.0
    for backend in ("native", "dis"):
        fl = metrics.dense_registration_flow(warped, gt, backend=backend)
        ld, ad = calibrate._ld_ad(fl, gt)
        assert abs(ld - ld_o) / ld_o < 0.08, (backend, ld, ld_o)
        assert abs(ad - ad_o) / ad_o < 0.08, (backend, ad, ad_o)


def test_native_scoring_needs_no_cv2(monkeypatch):
    """At equal sizes with the native engine (the card's machine: no cv2),
    ``evaluate_pair`` runs without OpenCV and gives MS-SSIM and the
    native flow's LD/AD."""
    gt, warped = _doc(120, 96, 9)

    def no_cv2():
        raise RuntimeError("cv2 required")

    monkeypatch.setattr(metrics, "_cv2", no_cv2)
    got = metrics.evaluate_pair(warped, gt, protocol_area=None,
                                flow_backend="native")
    flow = native.sift_flow(gt[..., 0], warped[..., 0])
    mag = np.sqrt((flow.astype(np.float64) ** 2).sum(-1))
    assert got["ms_ssim"] == metrics.ms_ssim(warped, gt)
    assert got["ld"] == pytest.approx(float(mag.mean()), rel=1e-6)
    assert got["ad"] == pytest.approx(calibrate._ld_ad(flow, gt[..., 0])[1],
                                      rel=1e-6)
    with pytest.raises(RuntimeError, match="cv2"):
        metrics.evaluate_pair(warped[:-4], gt, protocol_area=None,
                              flow_backend="native")


def test_native_build_is_atomic_and_failures_are_kept(tmp_path, monkeypatch):
    """Two concurrent builds of one library both succeed (a lock, a
    temporary file renamed into place) and leave one loadable file; a
    source that does not compile leaves no library, ``available()``
    false and the compiler's error."""
    path = tmp_path / "lib" / "_siftflow.so"
    errors = []
    threads = [threading.Thread(target=lambda: errors.append(
        native._build(path))) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == [None, None]
    assert sorted(os.listdir(path.parent)) == ["_siftflow.so", "lock"]

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    assert native.build_error()
    assert not list((tmp_path / "build").rglob("*.so"))
