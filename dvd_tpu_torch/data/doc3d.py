"""Doc3D training dataset, the host-side numpy pipeline (port of
``dvd_tpu/data/doc3d.py``; reference ``Aug_Doc3d_ListDataset``,
``datasets/listdataset.py:560-711``, and ``utils_data/io.py``).

- per-sample dirs with ``img.png`` / ``bm.mat`` / ``recon.png``
  (``load_pre_made_dataset.py:7-32``), a 0.97 train/val split;
- ``bm.mat``: h5py ``bm`` transposed (2, 1, 0), cropped to 447, scaled
  ``*511/447 - 1.2`` (load-bearing fudge factors, ``io.py:199-213``),
  resized per channel to 512^2: the absolute backward map, x first;
- ``recon.png`` thresholded above 1: the document mask;
- augmentation (``io.py:61-132``): a tight crop with random 5-25 px
  margins around the mask's box and the matching bm rescale, then the
  background replaced (a tiled texture, a random solid colour, or none);
- the intermediate warp ``bm_inter = lerp(base, bm, t / T)`` (production
  ``t = 0``, the identity) and a colour jitter of +-0.1
  (torchvision/kornia ColorJitter semantics);
- items: ``source_image`` (warped, jittered, [0, 1]), ``doc_mask``,
  ``flow_map = bm - base`` (absolute offsets), ``flow_map_inter``; or,
  with ``device_aug``, the composited ``image512`` [0, 255],
  ``doc_mask512`` and ``flow_map`` for ``data/device_aug.py`` to finish
  on the training device.

The same numpy and OpenCV code as ``dvd_tpu``'s, so items are equal to
its items for the same (index, seed).  cv2 and h5py are imported when a
function reads, resizes or warps, so a machine without them can import
this module; such a call raises ``RuntimeError``.  Bad samples raise
instead of printing and returning garbage (``io.py:188-212``).
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dvd_tpu_torch.data.benchmark import _cv2


def _h5py():
    try:
        import h5py
    except ImportError:
        raise RuntimeError("h5py required: it reads the Doc3D bm.mat "
                           "files") from None
    return h5py


# ---------------------------------------------------------------- discovery


def make_doc3d_sample_list(root: str, split: str = "train",
                           split_ratio: float = 0.97
                           ) -> List[Tuple[str, str, str]]:
    """Per-sample dirs containing img.png / bm.mat / recon.png
    (reference ``load_pre_made_dataset.py:7-20``)."""
    entries = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        img = os.path.join(d, "img.png")
        bm = os.path.join(d, "bm.mat")
        recon = os.path.join(d, "recon.png")
        if os.path.isfile(img) and os.path.isfile(bm) and os.path.isfile(recon):
            entries.append((img, bm, recon))
    cut = int(len(entries) * split_ratio)
    return entries[:cut] if split == "train" else entries[cut:]


# ------------------------------------------------------------------ loaders


def load_bm_mat(path: str, out_size: int = 512) -> np.ndarray:
    """h5py bm.mat -> (512, 512, 2) float absolute backward map, x first
    (reference ``io.py:199-213``)."""
    h5py, cv2 = _h5py(), _cv2()
    with h5py.File(path, "r") as f:
        bm = f["bm"][:].transpose((2, 1, 0))[:447, :447, :] * (511.0 / 447.0) - 1.2
    bm0 = cv2.resize(bm[:, :, 0], (out_size, out_size))
    bm1 = cv2.resize(bm[:, :, 1], (out_size, out_size))
    return np.stack([bm0, bm1], axis=-1)


def load_sample(img_path: str, bm_path: str, recon_path: str
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (img 512^2 RGB uint8, bm 512^2 float, mask 512^2 uint8 0/255)
    (reference ``default_loader3``, listdataset.py:89-95)."""
    cv2 = _cv2()
    img = cv2.imread(img_path, 1)[:, :, ::-1].astype(np.uint8)
    abd = cv2.imread(recon_path, cv2.IMREAD_GRAYSCALE)
    if img is None or abd is None:
        raise IOError(f"unreadable sample {img_path} / {recon_path}")
    _, mask = cv2.threshold(abd.astype(np.uint8), 1, 255, cv2.THRESH_BINARY)
    return (cv2.resize(img, (512, 512)), load_bm_mat(bm_path),
            cv2.resize(mask, (512, 512)))


# ------------------------------------------------------------- augmentation


def tight_crop(img: np.ndarray, mask: np.ndarray, bm: np.ndarray,
               rng: random.Random) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random-margin crop around the doc bbox, with the bm rescale from
    reference ``tight_crop_new`` (``io.py:61-104``).  mask: (H, W, 1) 0/255.
    Returns (img, mask in [0,1], bm)."""
    size = mask.shape
    ys, xs = np.nonzero(mask[:, :, 0])
    minx, maxx, miny, maxy = xs.min(), xs.max(), ys.min(), ys.max()
    cx1, cx2 = rng.randint(5, 25), rng.randint(5, 25)
    cy1, cy2 = rng.randint(5, 25), rng.randint(5, 25)
    final_minx = max(0, minx - cx1)
    final_maxx = min(size[1], maxx + cx2)
    final_miny = max(0, miny - cy1)
    final_maxy = min(size[0], maxy + cy2)

    img = img[final_miny:final_maxy, final_minx:final_maxx, :]
    mask = mask[final_miny:final_maxy, final_minx:final_maxx, :]

    t, b = final_miny, size[0] - final_maxy
    l, r = final_minx, size[1] - final_maxx
    bm = bm.copy()
    bm[:, :, 1] -= t
    bm[:, :, 0] -= l
    bm = 511.0 * bm / np.array([511.0 - l - r, 511.0 - t - b])
    return img, mask / 255.0, bm


def replace_background(img: np.ndarray, mask: np.ndarray,
                       texture: Optional[np.ndarray],
                       rng: random.Random) -> np.ndarray:
    """Reference ``augmentation`` bg branch (``io.py:106-132``)."""
    fh, fw = img.shape[:2]
    chance = rng.random()
    if chance > 0.3 and texture is not None:
        bg = _cv2().resize(texture, (200, 200))
        bg = np.tile(bg, (3, 3, 1))[:fh, :fw, :]
        msk = mask
    elif 0.2 < chance < 0.3 or (chance > 0.3 and texture is None):
        c = np.array([rng.random(), rng.random(), rng.random()])
        bg = np.ones((fh, fw, 3)) * c * 255.0
        msk = mask
    else:
        bg = np.zeros((fh, fw, 3))
        msk = np.ones((fh, fw, 3))
    return bg * (1 - msk) + img * msk


def color_jitter(img: np.ndarray, rng: random.Random, strength: float = 0.1
                 ) -> np.ndarray:
    """torchvision-style ColorJitter(0.1, 0.1, 0.1, 0.1) on a [0,1] float
    image, the four ops in a random order (reference
    ``listdataset.py:647`` via kornia)."""
    img = img.astype(np.float32)
    ops = list(range(4))
    rng.shuffle(ops)
    for op in ops:
        if op == 0:   # brightness
            img = img * rng.uniform(1 - strength, 1 + strength)
        elif op == 1:  # contrast
            mean = img.mean(axis=(0, 1), keepdims=True).mean()
            img = (img - mean) * rng.uniform(1 - strength, 1 + strength) + mean
        elif op == 2:  # saturation
            gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
            f = rng.uniform(1 - strength, 1 + strength)
            img = img * f + gray[..., None] * (1 - f)
        else:         # hue, in OpenCV's HSV degrees
            h = rng.uniform(-strength, strength)
            if abs(h) > 1e-6:
                cv2 = _cv2()
                hsv = cv2.cvtColor(np.clip(img, 0, 1), cv2.COLOR_RGB2HSV)
                hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
                img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return np.clip(img, 0.0, 1.0)


def bilinear_warp_np(img: np.ndarray, bm_abs: np.ndarray) -> np.ndarray:
    """Host-side grid_sample(align_corners=True, zeros) by absolute
    coordinates — the dataset's intermediate-warp op
    (reference ``listdataset.py:640-646``)."""
    cv2 = _cv2()
    mapx = bm_abs[:, :, 0].astype(np.float32)
    mapy = bm_abs[:, :, 1].astype(np.float32)
    return cv2.remap(img.astype(np.float32), mapx, mapy, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=0)


def base_grid_abs(size: int = 512) -> np.ndarray:
    """(size, size, 2) absolute pixel coordinates, x first, f32."""
    ys, xs = np.meshgrid(np.linspace(0, size - 1, size),
                         np.linspace(0, size - 1, size), indexing="ij")
    return np.stack([xs, ys], axis=-1).astype(np.float32)


# ------------------------------------------------------------------ dataset


@dataclasses.dataclass
class Doc3DDataset:
    """Map-style dataset; ``__getitem__(i, seed)`` is pure given (i, seed).

    ``load_fn`` decodes a sample: the bm.mat loader for Doc3D (reference
    ``default_loader3``) or the warped_BM.npz loader of the aug_doc family
    (``default_loader2``, see ``data/doc_npz.py``); the crop, background,
    intermediate warp and jitter are shared, as in the reference's
    Aug_ListDataset / Aug_Doc3d_ListDataset twins (listdataset.py:293-470,
    560-711)."""

    samples: Sequence[Tuple[str, str, str]]
    textures: Sequence[str] = ()
    inter_t: int = 0            # production t=0 (listdataset.py:625)
    inter_T: int = 20
    augment: bool = True
    jitter: bool = True
    load_fn: Optional[object] = None   # (img, bm, recon paths) -> triple
    # skip the host-side intermediate warp + jitter and ship the
    # composited image + bm for data/device_aug.augment_batch to finish on
    # the training device (keys image512 / doc_mask512 / flow_map)
    device_aug: bool = False

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int, seed: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        rng = random.Random(seed if seed is not None else index)
        loader = self.load_fn or load_sample
        img, bm, mask = loader(*self.samples[index])
        mask = mask.reshape(512, 512, 1)

        texture = None
        if self.textures:
            tex_path = self.textures[rng.randrange(len(self.textures))]
            texture = _cv2().imread(tex_path)
            if texture is not None:
                texture = texture[:, :, ::-1].astype(np.uint8)

        if self.augment:
            cv2 = _cv2()
            img, mask01, bm = tight_crop(img, mask, bm, rng)
            img = replace_background(img, mask01, texture, rng)
            mask = cv2.resize(mask01, (512, 512)).reshape(512, 512, 1)
            img = cv2.resize(img, (512, 512))
        else:
            mask = (mask / 255.0).astype(np.float32)

        base = base_grid_abs(512)
        frac = self.inter_t / self.inter_T
        if self.device_aug:
            return {
                "image512": np.asarray(img, np.float32),          # [0,255]
                "doc_mask512": mask.astype(np.float32),
                "flow_map": (bm - base).astype(np.float32),
            }
        bm_inter = ((1 - frac) * base + frac * bm).astype(np.float32)

        src = bilinear_warp_np(np.asarray(img, np.float32), bm_inter) / 255.0
        msk_inter = bilinear_warp_np(mask.astype(np.float32), bm_inter)
        if msk_inter.ndim == 2:
            msk_inter = msk_inter[..., None]
        if self.jitter:
            src = color_jitter(src, rng)

        return {
            "source_image": src.astype(np.float32),                # (512,512,3) [0,1]
            "doc_mask": msk_inter.astype(np.float32),               # (512,512,1)
            "flow_map": (bm - base).astype(np.float32),             # abs offsets
            "flow_map_inter": (bm_inter - base).astype(np.float32),
        }


def load_texture_list(path: str, root: str = "") -> List[str]:
    """Texture list file -> paths (the reference hard-codes its own home
    directory, ``listdataset.py:565-571``; here it is a config field)."""
    out = []
    with open(path) as f:
        for line in f:
            p = line.strip()
            if p:
                out.append(os.path.join(root, p) if root else p)
    return out
