"""The warped_BM.npz training-dataset family, ``dataset_name='doc_debug'``
and ``'aug_doc'`` (port of ``dvd_tpu/data/doc_npz.py``).

- sample discovery: per-sample dirs with ``warped_document.png`` /
  ``warped_BM.npz`` / ``warped_recon.png``, a 0.97 default split
  (reference ``datasets/load_pre_made_dataset.py:21-32,83-133``);
- ``load_bm_npz`` (reference ``load_gt_flow_npz``, ``utils_data/io.py:
  167-197``): the stored (448, 448, 2) ``warped_BM`` in [0, 1], y first,
  cropped to 447, scaled ``*511 + 0.4`` (this family's fudge factors, not
  the bm.mat path's ``*511/447 - 1.2``), resized per channel to 512^2,
  the channel axis rolled so x comes first;
- ``DocNpzDataset`` (reference ``Doc_Dataset`` -> ``ListDataset``,
  ``listdataset.py:121-291``): no augmentation; the source in [0, 1], the
  thresholded mask, ``flow = bm - base`` at 512^2 (the reference
  subtracts a stale 448^2 grid there, a shape error upstream) and a zero
  ``flow_map_inter`` (upstream emits none, and its losses slice it);
- ``AugDocNpzDataset`` (reference ``Aug_Doc_Dataset`` ->
  ``Aug_ListDataset``, ``listdataset.py:293-470``): the Doc3D pipeline of
  ``data/doc3d.py`` with this loader.

Items equal ``dvd_tpu``'s for the same (index, seed).  cv2 is imported
when a function reads, resizes or writes an image.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from dvd_tpu_torch.data.benchmark import _cv2
from dvd_tpu_torch.data.doc3d import Doc3DDataset, base_grid_abs

# ---------------------------------------------------------------- discovery


def make_doc_sample_list(root: str, split: str = "train",
                         split_ratio: float = 0.97
                         ) -> List[Tuple[str, str, str]]:
    """Per-sample dirs with warped_document.png / warped_BM.npz /
    warped_recon.png (reference ``load_pre_made_dataset.py:21-32``)."""
    entries = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        img = os.path.join(d, "warped_document.png")
        bm = os.path.join(d, "warped_BM.npz")
        recon = os.path.join(d, "warped_recon.png")
        if os.path.isfile(img) and os.path.isfile(bm) and os.path.isfile(recon):
            entries.append((img, bm, recon))
    cut = int(len(entries) * split_ratio)
    return entries[:cut] if split == "train" else entries[cut:]


# ------------------------------------------------------------------ loaders


def load_bm_npz(path: str, out_size: int = 512) -> np.ndarray:
    """warped_BM.npz -> (512, 512, 2) float absolute backward map, x first
    (reference ``load_gt_flow_npz``, io.py:167-197)."""
    cv2 = _cv2()
    bm = np.load(path)["warped_BM"][:447, :447, :] * 511.0 + 0.4
    bm0 = cv2.resize(bm[:, :, 0], (out_size, out_size))
    bm1 = cv2.resize(bm[:, :, 1], (out_size, out_size))
    bm = np.stack([bm0, bm1], axis=-1)
    return np.roll(bm, shift=1, axis=-1)


def load_sample_npz(img_path: str, bm_path: str, recon_path: str
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (img 512^2 RGB uint8, bm 512^2 float, mask 512^2 uint8 0/255)
    (reference ``default_loader2``, listdataset.py:52-74)."""
    cv2 = _cv2()
    img = cv2.imread(img_path, 1)
    abd = cv2.imread(recon_path, cv2.IMREAD_GRAYSCALE)
    if img is None or abd is None:
        raise IOError(f"unreadable sample {img_path} / {recon_path}")
    img = img[:, :, ::-1].astype(np.uint8)
    _, mask = cv2.threshold(abd.astype(np.uint8), 1, 255, cv2.THRESH_BINARY)
    return (cv2.resize(img, (512, 512)), load_bm_npz(bm_path),
            cv2.resize(mask, (512, 512)))


# ----------------------------------------------------------------- datasets


class DocNpzDataset:
    """The reference's basic ListDataset (``dataset_name='doc_debug'``): no
    augmentation, no intermediate warp (listdataset.py:121-291)."""

    def __init__(self, samples: Sequence[Tuple[str, str, str]]):
        self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int, seed=None):
        img, bm, mask = load_sample_npz(*self.samples[index])
        flow = (bm - base_grid_abs(512)).astype(np.float32)
        return {
            "source_image": (img / 255.0).astype(np.float32),
            "doc_mask": (mask.reshape(512, 512, 1) / 255.0).astype(np.float32),
            "flow_map": flow,
            "flow_map_inter": np.zeros_like(flow),
        }


def AugDocNpzDataset(samples, textures=(), **kw) -> Doc3DDataset:
    """The reference's Aug_ListDataset (``dataset_name='aug_doc'``): the
    shared augmentation pipeline with the npz loader
    (listdataset.py:293-470)."""
    return Doc3DDataset(samples=samples, textures=textures,
                        load_fn=load_sample_npz, **kw)


# ---------------------------------------------------------------- synthetic


def write_synthetic_doc_npz(root: str, n: int, seed: int = 0) -> str:
    """A synthetic dataset in this family's layout from the Doc3D page
    generator; ``warped_BM`` is stored as ``load_bm_npz`` reads it, (448,
    448, 2) in [0, 1], y first: the inverse of its crop, scale and roll."""
    from dvd_tpu_torch.data.synthetic import make_synthetic_sample

    cv2 = _cv2()
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        d = os.path.join(root, f"syn_{i:05d}")
        if os.path.isfile(os.path.join(d, "warped_recon.png")):
            continue
        os.makedirs(d, exist_ok=True)
        img, bm, mask = make_synthetic_sample(448, seed=seed * 100003 + i)
        # bm: x-first absolute 448-frame coords.  The loader returns
        # stored * 511 + 0.4 as 512-frame coords (its 447 -> 512 resize
        # moves the grid, not the values), and the 512-frame coords are
        # bm * 511/447 (as write_synthetic_doc3d's), so
        # stored = bm / 447 - 0.4 / 511, y first
        stored = np.roll(bm / 447.0 - 0.4 / 511.0, shift=1, axis=-1)
        np.savez_compressed(os.path.join(d, "warped_BM.npz"),
                            warped_BM=stored.astype(np.float32))
        cv2.imwrite(os.path.join(d, "warped_document.png"), img[:, :, ::-1])
        cv2.imwrite(os.path.join(d, "warped_recon.png"), mask)
    return root
