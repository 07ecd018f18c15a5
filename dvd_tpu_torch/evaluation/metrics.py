"""Dewarping metrics: MS-SSIM, LD and AD (port of
``dvd_tpu/evaluation/metrics.py``; the reference computes them offline in
MATLAB, ``matlab_code/run_benchmark.m`` / ``evalUnwarp.m``, with the
external SIFTflow toolbox).

- :func:`ms_ssim` -- multi-scale SSIM (Wang et al. 2003) as evalUnwarp
  computes it: 5 scales, weights [0.0448, 0.2856, 0.3001, 0.2363,
  0.1333], an 11x11 Gaussian of sigma 1.5, K = (0.01, 0.03), L = 255, on
  grayscale.
- :func:`local_distortion` -- LD: the mean magnitude of the dense
  registration flow from the rectified page to its scan, registered by
  the in-tree C++ engine (:mod:`dvd_tpu_torch.native`, sub-pixel) or
  OpenCV's DIS.  The error bounds measured against analytically known
  flows (``docs/registration_calibration.json``, :mod:`calibrate`):
  native median |rel err| 0.57% LD / 0.51% AD, DIS 0.42% / 0.49%, both
  ranking warp severities as the oracle does.
- :func:`aligned_distortion` -- AD (Ma et al.): the flow less its global
  translation, weighted by the scan's gradient magnitude.
- :func:`resize_keep_ar` -- the DocUNet protocol's resize to an area of
  598400 pixels (``run_docunet.m:63-115``).

Host code in float64 numpy, as in ``dvd_tpu``; each value equals its.
OpenCV (DIS, the resizes) and scipy (the SSIM filter) are imported inside
the functions that use them: a machine without cv2 scores pages of their
scans' size with the native engine (``evaluate_pair(..., protocol_area=
None, flow_backend="native")``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from dvd_tpu_torch.data.benchmark import _cv2

MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])


def _to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3 and img.shape[-1] == 3:
        img = img @ np.array([0.299, 0.587, 0.114])
    return img.astype(np.float64)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(k, k)
    return k / k.sum()


def _filter2_valid(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid'-mode 2D correlation (matches MATLAB filter2(...,'valid'))."""
    from scipy.signal import fftconvolve

    return fftconvolve(img, kernel[::-1, ::-1], mode="valid")


def ssim_index(img1: np.ndarray, img2: np.ndarray, k1: float = 0.01,
               k2: float = 0.03, L: float = 255.0,
               ) -> Tuple[float, float]:
    """Single-scale SSIM returning (mean ssim, mean contrast-structure)."""
    img1 = _to_gray(img1)
    img2 = _to_gray(img2)
    kern = _gaussian_kernel()
    c1, c2 = (k1 * L) ** 2, (k2 * L) ** 2

    mu1 = _filter2_valid(img1, kern)
    mu2 = _filter2_valid(img2, kern)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2_valid(img1 * img1, kern) - mu1_sq
    s2 = _filter2_valid(img2 * img2, kern) - mu2_sq
    s12 = _filter2_valid(img1 * img2, kern) - mu12

    cs_map = (2 * s12 + c2) / (s1 + s2 + c2)
    ssim_map = ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return float(ssim_map.mean()), float(cs_map.mean())


def ms_ssim(img1: np.ndarray, img2: np.ndarray, weights=MSSSIM_WEIGHTS) -> float:
    """Multi-scale SSIM on grayscale uint8-range images (downsample by 2
    with a 2x2 average between scales, as in the canonical MATLAB code)."""
    img1 = _to_gray(img1)
    img2 = _to_gray(img2)
    levels = len(weights)
    mcs = []
    val = 1.0
    for i in range(levels):
        s, cs = ssim_index(img1, img2)
        if i < levels - 1:
            mcs.append(max(cs, 1e-6))
            img1 = _downsample2(img1)
            img2 = _downsample2(img2)
        else:
            val = max(s, 1e-6)
    out = val ** weights[-1]
    for w, cs in zip(weights[:-1], mcs):
        out *= cs**w
    return float(out)


def _downsample2(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    img = img[: h - h % 2, : w - w % 2]
    return (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2]) / 4.0


def dense_registration_flow(rectified: np.ndarray, gt: np.ndarray,
                            backend: str = "auto") -> np.ndarray:
    """Dense flow gt -> rectified, (H, W, 2).

    backend="native" uses the in-tree C++ dense-descriptor coarse-to-fine
    engine (:func:`dvd_tpu_torch.native.sift_flow`, in place of the
    external SIFTflow toolbox the MATLAB metrics require); "dis" uses
    OpenCV's DIS optical flow; "auto" prefers native and falls back to
    DIS.
    """
    g1 = _to_gray(gt).astype(np.float32)
    g2 = _to_gray(rectified).astype(np.float32)

    if backend in ("auto", "native"):
        from dvd_tpu_torch import native

        if native.available():
            return native.sift_flow(g1, g2)
        if backend == "native":
            raise RuntimeError(
                f"native siftflow unavailable: {native.build_error()}")

    cv2 = _cv2()
    # local contrast normalization stabilizes registration on documents
    norm = lambda g: cv2.GaussianBlur(g, (0, 0), 1.0)
    g1 = cv2.normalize(norm(g1), None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
    g2 = cv2.normalize(norm(g2), None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
    dis = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    return dis.calc(g1, g2, None)


def local_distortion(rectified: np.ndarray, gt: np.ndarray,
                     backend: str = "auto") -> float:
    """LD: mean registration-flow magnitude (evalUnwarp's second output)."""
    flow = dense_registration_flow(rectified, gt, backend)
    return float(np.sqrt((flow**2).sum(-1)).mean())


def aligned_distortion(rectified: np.ndarray, gt: np.ndarray,
                       backend: str = "auto") -> float:
    """AD: remove the global mean displacement, weight residual flow
    magnitude by GT gradient energy (evalAlignedUnwarp behavior)."""
    flow = dense_registration_flow(rectified, gt, backend)
    flow = flow - flow.mean(axis=(0, 1), keepdims=True)
    g = _to_gray(gt)
    gy, gx = np.gradient(g)
    wgt = np.sqrt(gx**2 + gy**2)
    wgt = wgt / max(wgt.sum(), 1e-9)
    mag = np.sqrt((flow**2).sum(-1))
    return float((mag * wgt).sum())


def resize_keep_ar(img: np.ndarray, target_area: float = 598400.0) -> np.ndarray:
    """DocUNet protocol resize: scale to a fixed pixel area keeping the
    aspect ratio (``run_docunet.m:63-115``)."""
    h, w = img.shape[:2]
    scale = math.sqrt(target_area / (h * w))
    return _cv2().resize(img, (int(round(w * scale)), int(round(h * scale))))


def evaluate_pair(rectified: np.ndarray, gt: np.ndarray,
                  protocol_area: Optional[float] = 598400.0,
                  flow_backend: str = "auto") -> dict:
    """Full per-image metric set (MS-SSIM, LD, AD) under the DocUNet
    protocol: both images resized to the same fixed area, rectified then
    matched to GT's exact size."""
    if protocol_area:
        gt = resize_keep_ar(gt, protocol_area)
    if rectified.shape[:2] != gt.shape[:2]:    # OpenCV copies at equal size
        rectified = _cv2().resize(rectified, (gt.shape[1], gt.shape[0]))
    flow = dense_registration_flow(rectified, gt, flow_backend)
    mag = np.sqrt((flow**2).sum(-1))
    centered = flow - flow.mean(axis=(0, 1), keepdims=True)
    g = _to_gray(gt)
    gy, gx = np.gradient(g)
    wgt = np.sqrt(gx**2 + gy**2)
    wgt = wgt / max(wgt.sum(), 1e-9)
    return {
        "ms_ssim": ms_ssim(rectified, gt),
        "ld": float(mag.mean()),
        "ad": float((np.sqrt((centered**2).sum(-1)) * wgt).sum()),
    }
