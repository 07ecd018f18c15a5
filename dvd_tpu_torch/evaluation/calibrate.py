"""LD/AD registration-engine calibration (port of
``dvd_tpu/evaluation/calibrate.py``), and the synthetic pages and exact
registration flows the synthetic training set draws with.

The reference defines LD/AD through SIFTflow registration in MATLAB
(``matlab_code/run_benchmark.m:43-44``).  This module measures how
closely the two registration backends -- the in-tree C++ engine
(:mod:`dvd_tpu_torch.native`) and OpenCV's DIS -- track the true
registration flow on document pages with known deformations:

1. render synthetic text pages (:func:`render_document`);
2. warp them with smooth random displacement fields ``u`` spanning the LD
   range reported on DocUNet (:func:`random_warp_field`,
   :func:`apply_warp`);
3. the oracle flow ``v`` (gt -> warped) solves ``v(p) = -u(p + v(p))``
   (:func:`oracle_registration_flow`, fixed-point iteration);
4. compare each backend's LD/AD with the oracle's per magnitude.

Run: ``python -m dvd_tpu_torch.evaluation.calibrate [--out results.json]``
(``dvd_tpu``'s snapshot is ``docs/registration_calibration.json``).

numpy + OpenCV, equal to ``dvd_tpu``'s values; cv2 is imported when a
function is called, so a machine without it can import this module.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from dvd_tpu_torch.data.benchmark import _cv2

_WORDS = ("lorem ipsum dolor sit amet consectetur adipiscing elit sed do "
          "eiusmod tempor incididunt ut labore et dolore magna aliqua enim "
          "ad minim veniam quis nostrud exercitation ullamco laboris").split()


def render_document(h: int, w: int, seed: int) -> np.ndarray:
    """Synthetic grayscale document page, (h, w) float32 in [0, 255]: text
    lines with paragraph breaks, a ruled header, an outlined figure box
    and a little noise (``dvd_tpu/evaluation/calibrate.py:47``)."""
    cv2 = _cv2()
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 245, np.uint8)  # cv2 drawing wants uint8

    y = int(h * 0.06)
    line_h = max(12, int(h * 0.028))
    font = cv2.FONT_HERSHEY_SIMPLEX
    scale = line_h / 28.0
    while y < h * 0.94:
        if rng.rand() < 0.08:            # paragraph break
            y += line_h
            continue
        x = int(w * 0.07)
        n_words = rng.randint(4, 10)
        text = " ".join(rng.choice(_WORDS) for _ in range(n_words))
        cv2.putText(img, text, (x, y), font, scale, 30, 1, cv2.LINE_AA)
        y += int(line_h * 1.4)
    cv2.line(img, (int(w * 0.07), int(h * 0.045)),
             (int(w * 0.93), int(h * 0.045)), 60, 1, cv2.LINE_AA)
    bx, by = int(w * rng.uniform(0.15, 0.5)), int(h * rng.uniform(0.3, 0.6))
    cv2.rectangle(img, (bx, by), (bx + w // 4, by + h // 6), 80, 1)
    out = img.astype(np.float32) + rng.randn(h, w).astype(np.float32) * 2.0
    return np.clip(out, 0, 255)


def random_warp_field(h: int, w: int, magnitude: float, seed: int
                      ) -> np.ndarray:
    """Smooth random displacement field u, (H, W, 2), peak ~magnitude px:
    two sinusoid harmonics + a Gaussian bump, the residual-distortion
    shape real dewarpers leave behind."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    u = np.zeros((h, w, 2))
    for c in range(2):
        f1, f2 = rng.uniform(0.5, 1.5, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        a1, a2 = rng.dirichlet([1, 1]) * magnitude
        u[..., c] = (a1 * np.sin(2 * np.pi * f1 * ys / h + p1)
                     + a2 * np.sin(2 * np.pi * f2 * xs / w + p2))
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    sig = 0.25 * min(h, w)
    bump = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sig**2))
    u[..., 0] += 0.3 * magnitude * bump * rng.choice([-1, 1])
    return u.astype(np.float32)


def apply_warp(img: np.ndarray, u: np.ndarray) -> np.ndarray:
    """warped(p) = img(p + u(p)) via bilinear sampling."""
    cv2 = _cv2()
    h, w = img.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    mx = xs + u[..., 0]
    my = ys + u[..., 1]
    return cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE)


def oracle_registration_flow(u: np.ndarray, iters: int = 8) -> np.ndarray:
    """The flow v (H, W, 2) with ``v(p) = -u(p + v(p))`` for a smooth
    displacement field ``u`` (H, W, 2), by fixed-point iteration
    (``dvd_tpu/evaluation/calibrate.py:109``): the inverse of the warp
    ``p -> p + u(p)`` as an offset field."""
    cv2 = _cv2()
    h, w = u.shape[:2]
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    v = -u.copy()
    for _ in range(iters):
        mx = xs + v[..., 0]
        my = ys + v[..., 1]
        ux = cv2.remap(u[..., 0], mx, my, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REPLICATE)
        uy = cv2.remap(u[..., 1], mx, my, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REPLICATE)
        v = -np.stack([ux, uy], -1)
    return v


def _ld_ad(flow: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    mag = np.sqrt((flow.astype(np.float64) ** 2).sum(-1))
    centered = flow - flow.mean(axis=(0, 1), keepdims=True)
    gy, gx = np.gradient(gt.astype(np.float64))
    wgt = np.sqrt(gx**2 + gy**2)
    wgt = wgt / max(wgt.sum(), 1e-9)
    ad = float((np.sqrt((centered.astype(np.float64) ** 2).sum(-1)) * wgt).sum())
    return float(mag.mean()), ad


def run_calibration(h: int = 640, w: int = 512,
                    magnitudes=(2.0, 4.0, 8.0, 16.0),
                    n_docs: int = 3) -> Dict:
    """Returns per-magnitude oracle/native/DIS LD+AD and relative errors."""
    from dvd_tpu_torch import native
    from dvd_tpu_torch.evaluation.metrics import dense_registration_flow

    rows: List[Dict] = []
    for mag in magnitudes:
        for d in range(n_docs):
            gt = render_document(h, w, seed=100 + d)
            u = random_warp_field(h, w, mag, seed=1000 + 10 * d + int(mag))
            warped = apply_warp(gt, u)
            v = oracle_registration_flow(u)
            ld_o, ad_o = _ld_ad(v, gt)
            row = {"magnitude": mag, "doc": d, "ld_oracle": ld_o,
                   "ad_oracle": ad_o}
            if native.available():
                fl = native.sift_flow(gt, warped)
                row["ld_native"], row["ad_native"] = _ld_ad(fl, gt)
            fl = dense_registration_flow(warped, gt, backend="dis")
            row["ld_dis"], row["ad_dis"] = _ld_ad(fl, gt)
            rows.append(row)

    def rel_errs(key: str) -> List[float]:
        return [abs(r[f"{key[:2]}_{key[3:]}"] - r[f"{key[:2]}_oracle"])
                / max(r[f"{key[:2]}_oracle"], 1e-9)
                for r in rows if f"{key[:2]}_{key[3:]}" in r]

    summary = {}
    for metric in ("ld", "ad"):
        for backend in ("native", "dis"):
            errs = rel_errs(f"{metric}_{backend}")
            if errs:
                summary[f"{metric}_{backend}_relerr_median"] = float(
                    np.median(errs))
                summary[f"{metric}_{backend}_relerr_max"] = float(np.max(errs))
    # rank consistency: does each backend order the warp magnitudes the
    # same way the oracle does? (what matters for comparing methods)
    for metric in ("ld", "ad"):
        for backend in ("native", "dis"):
            key = f"{metric}_{backend}"
            if all(key in r for r in rows):
                o = [r[f"{metric}_oracle"] for r in rows]
                b = [r[key] for r in rows]
                summary[f"{key}_spearman"] = _spearman(o, b)
    return {"rows": rows, "summary": summary,
            "resolution": [h, w], "n_docs": n_docs,
            "magnitudes": list(magnitudes)}


def _spearman(a, b) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    den = float(np.sqrt((ra**2).sum() * (rb**2).sum()))
    return float((ra * rb).sum() / den) if den else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="registration_calibration.json")
    ap.add_argument("--height", type=int, default=640)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--n_docs", type=int, default=3)
    args = ap.parse_args(argv)

    res = run_calibration(args.height, args.width, n_docs=args.n_docs)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res["summary"], indent=2))


if __name__ == "__main__":
    main()
