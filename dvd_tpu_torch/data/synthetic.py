"""Synthetic Doc3D-format dataset generator (port of
``dvd_tpu/data/synthetic.py``).

Writes per-sample dirs (``img.png`` / ``bm.mat`` / ``recon.png``) in the
on-disk layout ``data/doc3d.py`` reads (reference
``load_pre_made_dataset.py:7-20``, ``listdataset.py:89-95``), so the
whole training path (the bm.mat parse, crop, background, augmentation,
loader) runs without the Doc3D download:
``python -m dvd_tpu_torch.cli.run_training --synthetic N``.

A flat text page D is drawn (``evaluation/calibrate.render_document``),
a smooth random warped -> flat map psi is drawn, the photo is
``img(q) = D(psi(q))`` by remap, and the backward map ``bm = psi^-1``
(flat -> warped) comes from fixed-point inversion, so ``unwarp(img, bm)``
gives D back and the flow is learnable.  The same numpy, OpenCV and h5py
code as ``dvd_tpu``'s: samples equal its samples for the same seed.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Tuple

import numpy as np

from dvd_tpu_torch.data.benchmark import _cv2
from dvd_tpu_torch.data.doc3d import _h5py
from dvd_tpu_torch.evaluation.calibrate import (oracle_registration_flow,
                                                render_document)


def _render_doc_rgb(size: int, seed: int) -> np.ndarray:
    """Tinted text page, (size, size, 3) uint8."""
    rng = np.random.RandomState(seed)
    g = render_document(size, size, seed)
    tint = rng.uniform(0.88, 1.0, 3)
    return np.clip(g[..., None] * tint[None, None], 0, 255).astype(np.uint8)


def _smooth_field(size: int, magnitude: float, rng: np.random.RandomState
                  ) -> np.ndarray:
    """Smooth random displacement field, (size, size, 2), ~magnitude px."""
    ys, xs = np.meshgrid(np.arange(size, dtype=np.float64),
                         np.arange(size, dtype=np.float64), indexing="ij")
    u = np.zeros((size, size, 2))
    for c in range(2):
        f1, f2 = rng.uniform(0.4, 1.2, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        a1, a2 = rng.dirichlet([1, 1]) * magnitude
        u[..., c] = (a1 * np.sin(2 * np.pi * f1 * ys / size + p1)
                     + a2 * np.cos(2 * np.pi * f2 * xs / size + p2))
    return u.astype(np.float32)


def make_synthetic_sample(size: int, seed: int, magnitude: float = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (img RGB uint8, bm float32 (size, size, 2) flat -> warped absolute
    coords, mask uint8 0/255 in the warped frame)."""
    cv2 = _cv2()
    rng = np.random.RandomState(seed)
    if magnitude is None:
        magnitude = rng.uniform(8.0, size * 0.07)
    doc = _render_doc_rgb(size, seed)

    # warped -> flat sampling map psi(q) = q + u(q), shrunk toward the
    # centre so the warped page sits inside the frame with margins
    margin = 0.08
    u = _smooth_field(size, magnitude, rng)
    ys, xs = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    scale = 1.0 / (1.0 - 2 * margin)
    psi_x = (xs - margin * size) * scale + u[..., 0]
    psi_y = (ys - margin * size) * scale + u[..., 1]

    img = cv2.remap(doc, psi_x, psi_y, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    inside = ((psi_x >= 0) & (psi_x <= size - 1)
              & (psi_y >= 0) & (psi_y <= size - 1))
    mask = (inside * 255).astype(np.uint8)
    img[~inside] = 0

    # bm = psi^-1: where flat pixel p lives in the warped photo
    du = np.stack([psi_x - xs, psi_y - ys], -1)
    v = oracle_registration_flow(du, iters=10)
    bm = np.stack([xs + v[..., 0], ys + v[..., 1]], -1).astype(np.float32)
    return img, bm, mask


def write_synthetic_doc3d(root: str, n: int, size: int = 448,
                          seed: int = 0) -> str:
    """Write n samples under root in the Doc3D layout; returns root.
    bm.mat holds an HDF5 ``bm`` dataset whose ``transpose((2, 1, 0))`` is
    the (H, W, 2) coords in [0, size - 1] (the reference's MATLAB v7.3
    axis order), as ``load_bm_mat`` reads it.

    Idempotent per (seed, size): a manifest records the generation's
    parameters, and a rerun with others regenerates every sample instead
    of mixing generations or ignoring the new seed."""
    if size != 448:
        raise ValueError("the generator is calibrated for Doc3D's 448 px "
                         f"frame, not {size}")
    h5py, cv2 = _h5py(), _cv2()
    os.makedirs(root, exist_ok=True)
    manifest_path = os.path.join(root, "synthetic_manifest.json")
    manifest = {"seed": seed, "size": size}
    stale = True
    if os.path.isfile(manifest_path):
        with open(manifest_path) as f:
            stale = json.load(f) != manifest
    if stale:
        for name in os.listdir(root):
            d = os.path.join(root, name)
            if name.startswith("syn_") and os.path.isdir(d):
                shutil.rmtree(d)
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)
    for i in range(n):
        d = os.path.join(root, f"syn_{i:05d}")
        if os.path.isfile(os.path.join(d, "recon.png")):
            continue  # already generated
        os.makedirs(d, exist_ok=True)
        img, bm, mask = make_synthetic_sample(size, seed=seed * 100003 + i)
        cv2.imwrite(os.path.join(d, "img.png"), img[:, :, ::-1])
        # load_bm_mat returns stored * 511/447 - 1.2 as coords in the
        # 512-resized frame, and load_sample resizes the 448 px image to
        # 512 (coords scale by 511/447): store the 448-frame coords plus
        # the offset's compensation
        stored = bm + 1.2 * (447.0 / 511.0)
        with h5py.File(os.path.join(d, "bm.mat"), "w") as f:
            f.create_dataset("bm", data=stored.transpose((2, 1, 0)),
                             compression="gzip", compression_opts=1)
        # recon.png is the idempotency sentinel, written last: a sample
        # killed half-way is regenerated by the next run
        cv2.imwrite(os.path.join(d, "recon.png"), mask)
    return root
