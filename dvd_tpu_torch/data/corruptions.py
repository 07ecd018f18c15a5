"""Image corruptions for the robustness sweep (``run_sampling
--corruption``); port of ``dvd_tpu/data/corruptions.py``.

The reference's ``run_sampling.py:52-58`` loops severities x 15
corruption ids over the eval set (the ImageNet-C set).  These are numpy
and OpenCV versions of the same corruption families at 5 severities,
equal to ``dvd_tpu``'s value for value.  OpenCV is imported inside the
corruptions that use it, so a machine without cv2 imports this module and
runs the others (:data:`NEEDS_CV2` names which need it).  One departure:
``frost`` takes ``np.ptp(noise)`` where ``dvd_tpu`` calls
``noise.ptp()``, which NumPy 2 removed (the same value).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from dvd_tpu_torch.data.benchmark import BenchmarkDataset, _cv2


def _rng(img):
    return np.random.RandomState(np.int64(np.abs(img[:8, :8].sum()) * 1000) % (2**31))


def gaussian_noise(x, s):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][s - 1]
    return np.clip(x + _rng(x).normal(size=x.shape, scale=c), 0, 1)


def shot_noise(x, s):
    c = [60, 25, 12, 5, 3][s - 1]
    return np.clip(_rng(x).poisson(x * c) / float(c), 0, 1)


def impulse_noise(x, s):
    c = [0.03, 0.06, 0.09, 0.17, 0.27][s - 1]
    r = _rng(x)
    out = x.copy()
    m = r.rand(*x.shape[:2])
    out[m < c / 2] = 0.0
    out[m > 1 - c / 2] = 1.0
    return out


def defocus_blur(x, s):
    cv2 = _cv2()
    c = [3, 4, 6, 8, 10][s - 1]
    k = np.zeros((2 * c + 1, 2 * c + 1), np.float32)
    cv2.circle(k, (c, c), c, 1.0, -1)
    k /= k.sum()
    return np.clip(cv2.filter2D(x, -1, k), 0, 1)


def glass_blur(x, s):
    cv2 = _cv2()
    c = [1, 2, 3, 4, 5][s - 1]
    r = _rng(x)
    h, w = x.shape[:2]
    out = x.copy()
    for _ in range(c):
        dx = r.randint(-c, c + 1, (h, w))
        dy = r.randint(-c, c + 1, (h, w))
        ys = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
        xs = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
        out = out[ys, xs]
    return cv2.GaussianBlur(out, (0, 0), sigmaX=c * 0.5)


def motion_blur(x, s):
    cv2 = _cv2()
    c = [9, 13, 17, 21, 25][s - 1]
    k = np.zeros((c, c), np.float32)
    k[c // 2, :] = 1.0 / c
    ang = float(_rng(x).uniform(-45, 45))
    m = cv2.getRotationMatrix2D((c / 2, c / 2), ang, 1.0)
    k = cv2.warpAffine(k, m, (c, c))
    k /= max(k.sum(), 1e-8)
    return np.clip(cv2.filter2D(x, -1, k), 0, 1)


def zoom_blur(x, s):
    cv2 = _cv2()
    c = [1.06, 1.11, 1.16, 1.21, 1.26][s - 1]
    h, w = x.shape[:2]
    acc = np.zeros_like(x)
    zooms = np.linspace(1.0, c, 8)
    for z in zooms:
        zh, zw = int(h / z), int(w / z)
        y0, x0 = (h - zh) // 2, (w - zw) // 2
        crop = x[y0:y0 + zh, x0:x0 + zw]
        acc += cv2.resize(crop, (w, h))
    return np.clip(acc / len(zooms), 0, 1)


def snow(x, s):
    cv2 = _cv2()
    c = [0.05, 0.1, 0.15, 0.2, 0.3][s - 1]
    r = _rng(x)
    layer = (r.rand(*x.shape[:2]) < c).astype(np.float32)
    layer = cv2.GaussianBlur(layer, (0, 0), 1.0)[..., None]
    return np.clip(x * (1 - layer) + layer, 0, 1)


def frost(x, s):
    cv2 = _cv2()
    c = [0.15, 0.25, 0.35, 0.45, 0.55][s - 1]
    r = _rng(x)
    noise = cv2.GaussianBlur(r.rand(*x.shape[:2]).astype(np.float32), (0, 0), 4)
    noise = (noise - noise.min()) / max(np.ptp(noise), 1e-8)
    return np.clip(x * (1 - c) + noise[..., None] * c + 0.1 * c, 0, 1)


def fog(x, s):
    c = [0.4, 0.5, 0.6, 0.7, 0.8][s - 1]
    return np.clip(x * (1 - c) + c, 0, 1)


def brightness(x, s):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][s - 1]
    return np.clip(x + c, 0, 1)


def contrast(x, s):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][s - 1]
    m = x.mean(axis=(0, 1), keepdims=True)
    return np.clip((x - m) * c + m, 0, 1)


def elastic_transform(x, s):
    cv2 = _cv2()
    c = [0.05, 0.065, 0.085, 0.1, 0.12][s - 1]
    h, w = x.shape[:2]
    r = _rng(x)
    dx = cv2.GaussianBlur((r.rand(h, w) * 2 - 1).astype(np.float32), (0, 0), 8) * c * w
    dy = cv2.GaussianBlur((r.rand(h, w) * 2 - 1).astype(np.float32), (0, 0), 8) * c * h
    mx = (np.arange(w)[None, :] + dx).astype(np.float32)
    my = (np.arange(h)[:, None] + dy).astype(np.float32)
    return cv2.remap(x, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)


def pixelate(x, s):
    cv2 = _cv2()
    c = [0.6, 0.5, 0.4, 0.3, 0.25][s - 1]
    h, w = x.shape[:2]
    small = cv2.resize(x, (max(1, int(w * c)), max(1, int(h * c))),
                       interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


def jpeg_compression(x, s):
    cv2 = _cv2()
    c = [25, 18, 15, 10, 7][s - 1]
    ok, enc = cv2.imencode(".jpg", (x[:, :, ::-1] * 255).astype(np.uint8),
                           [int(cv2.IMWRITE_JPEG_QUALITY), c])
    dec = cv2.imdecode(enc, 1)[:, :, ::-1]
    return dec.astype(np.float32) / 255.0


CORRUPTIONS: Dict[str, Callable] = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "glass_blur": glass_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
}


# the corruptions that need OpenCV (a machine without cv2 runs the rest)
NEEDS_CV2 = ("defocus_blur", "glass_blur", "motion_blur", "zoom_blur", "snow",
             "frost", "elastic_transform", "pixelate", "jpeg_compression")


def corrupt(img01: np.ndarray, name: str, severity: int) -> np.ndarray:
    """``name`` at ``severity`` (1-5) of an (H, W, 3) RGB image in [0, 1];
    float32 out, seeded by the image's top-left 8x8 block."""
    if name not in CORRUPTIONS:
        raise KeyError(f"unknown corruption {name}; "
                       f"choose from {sorted(CORRUPTIONS)}")
    if not 1 <= severity <= 5:
        raise ValueError("severity must be 1..5")
    return CORRUPTIONS[name](img01.astype(np.float32), severity).astype(np.float32)


def corrupt_item(item: Dict, name: str, severity: int) -> Dict:
    """A ``BenchmarkDataset`` item with its 512^2 source and its native
    canvas corrupted, as ``dvd_tpu``'s sweep does (``run_sampling.py:
    173-179``): the canvas goes to [0, 1], is corrupted, and back to
    uint8 by truncation."""
    out = dict(item)
    out["source_image"] = corrupt(item["source_image"], name, severity)
    pad = item["source_padded"].astype(np.float32) / 255.0
    out["source_padded"] = (corrupt(pad, name, severity) * 255).astype(
        np.uint8)
    return out


@dataclasses.dataclass
class CorruptedDataset:
    """``base`` (a ``BenchmarkDataset`` or one of its subclasses) with every
    item corrupted by ``name`` at ``severity`` (:func:`corrupt_item`);
    batched as the base is."""

    base: BenchmarkDataset
    name: str
    severity: int

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> Dict:
        return corrupt_item(self.base[i], self.name, self.severity)

    batches = BenchmarkDataset.batches


def corruption_names(arg: str):
    """The corruptions ``--corruption`` names: one id, or ``all`` (every
    id, sorted); an unknown id raises ``SystemExit`` listing the valid
    ones."""
    names = sorted(CORRUPTIONS) if arg == "all" else [arg]
    unknown = [n for n in names if n not in CORRUPTIONS]
    if unknown:
        raise SystemExit(
            f"unknown corruption(s) {unknown}; valid: {sorted(CORRUPTIONS)}")
    return names
