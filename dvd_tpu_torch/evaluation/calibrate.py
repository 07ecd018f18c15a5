"""Synthetic document pages and exact registration flows (the two
functions of ``dvd_tpu/evaluation/calibrate.py`` that the synthetic
training set draws with; the metric calibration itself is not ported).

Both are numpy + OpenCV and give ``dvd_tpu``'s values exactly.  cv2 is
imported when a function is called, so a machine without it can import
this module.
"""

from __future__ import annotations

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
