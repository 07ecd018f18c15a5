"""Visualization: saving dewarped outputs and colouring flows (port of
``dvd_tpu/evaluation/visualize.py``; reference
``utils_flow/visualization_utils.py`` and ``datasets/utils/flow_viz.py``,
the Baker et al. colour wheel).  numpy only; PIL is imported by
:func:`save_dewarped` alone."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def make_color_wheel() -> np.ndarray:
    """(55, 3) RGB color wheel (RY/YG/GC/CB/BM/MR segments)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray, clip: Optional[float] = None) -> np.ndarray:
    """(H, W, 2) flow -> uint8 RGB visualization."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    if clip:
        u = np.clip(u, -clip, clip)
        v = np.clip(v, -clip, clip)
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(rad.max(), 1e-9)
    u, v = u / maxrad, v / maxrad

    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., i] = np.floor(255 * col)
    return img


def save_dewarped(out_dir: str, name: str, image: np.ndarray) -> str:
    """Reference naming: dewarped_pred/warped_{name}
    (``visualization_utils.py:64-91``)."""
    from PIL import Image

    pred_dir = os.path.join(out_dir, "dewarped_pred")
    os.makedirs(pred_dir, exist_ok=True)
    path = os.path.join(pred_dir, f"warped_{name}")
    Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).save(path)
    return path
