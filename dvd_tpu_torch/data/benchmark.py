"""Benchmark (evaluation) datasets: a flat directory of photographed
documents (DocUNet-130, DIR300, AnyPhotoDoc6300, DocReal).  Port of
``dvd_tpu/data/benchmark.py`` (reference ``doc_benchmark.py``,
``Doc_benchmark``).

Each item is the 512^2-resized [0, 1] source image plus the untouched
original, padded into a fixed (P, P) uint8 canvas, so a whole batch of
pages of any sizes goes through one ``unwarp_native`` call.  Items and
batches equal ``dvd_tpu``'s: the same cv2 decode and resizes, the same
fit canvas, the same padding by repetition.

cv2 (decode, resize) and PIL (the header read of the fit canvas) are
imported only when an item is read or the canvas is fitted; a machine
without them can still import this module and subclass the dataset.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".tif")


def _cv2():
    """OpenCV, imported when a function first reads, resizes, draws or
    writes an image; a clear error on a machine without it."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 required: OpenCV reads, resizes, draws and "
                           "writes the images") from None
    cv2.setNumThreads(0)
    return cv2


def list_benchmark_images(root: str) -> List[str]:
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(IMAGE_EXTS):
                out.append(os.path.join(dirpath, f))
    return out


@dataclasses.dataclass
class BenchmarkDataset:
    paths: Sequence[str]
    source_size: int = 512
    pad_to: int = 0             # canvas for native-size unwarp; 0 = fit
    max_side: Optional[int] = None  # optionally downscale huge originals
    # fit-canvas ceiling: originals larger than this are downscaled to it
    # before unwarping (the reference unwarps at true native size,
    # evaluation.py:300-306); 4096 covers AnyPhotoDoc's largest photos.
    # 0 for no ceiling.
    canvas_cap: int = 4096

    def __post_init__(self):
        if not self.pad_to:
            self.pad_to = self._fit_canvas()

    def _fit_canvas(self) -> int:
        """Smallest multiple-of-256 canvas covering every image (read from
        headers only), capped by ``canvas_cap`` and ``max_side``."""
        from PIL import Image

        m = 256
        for p in self.paths:
            try:
                with Image.open(p) as im:
                    m = max(m, *im.size)
            except OSError:
                continue
        if self.canvas_cap:
            m = min(m, self.canvas_cap)
        if self.max_side:
            m = min(m, self.max_side)
        return -(-m // 256) * 256

    @classmethod
    def from_dir(cls, root: str, **kw) -> "BenchmarkDataset":
        return cls(paths=list_benchmark_images(root), **kw)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        cv2 = _cv2()
        path = self.paths[i]
        ori = cv2.imread(path, 1)
        if ori is None:
            raise IOError(f"unreadable image {path}")
        ori = ori[:, :, ::-1]  # BGR -> RGB
        if self.max_side and max(ori.shape[:2]) > self.max_side:
            scale = self.max_side / max(ori.shape[:2])
            ori = cv2.resize(ori, (int(ori.shape[1] * scale),
                                   int(ori.shape[0] * scale)))
        h, w = ori.shape[:2]
        p = self.pad_to
        if max(h, w) > p:
            scale = p / max(h, w)
            ori = cv2.resize(ori, (int(w * scale), int(h * scale)))
            h, w = ori.shape[:2]

        src = cv2.resize(ori, (self.source_size, self.source_size)) \
            .astype(np.float32) / 255.0

        padded = np.zeros((p, p, 3), np.uint8)
        padded[:h, :w] = ori
        return {
            "source_image": src,            # (S, S, 3) [0,1]
            "source_padded": padded,        # (P, P, 3) uint8
            "hw": np.array([h, w], np.int32),
            "path": path,
        }

    def batches(self, batch_size: int):
        """Yield padded numpy batches (the last batch padded by repeating
        its last item, so every step has one shape; 'count' marks the
        real items)."""
        n = len(self)
        for start in range(0, n, batch_size):
            idx = list(range(start, min(start + batch_size, n)))
            count = len(idx)
            while len(idx) < batch_size:
                idx.append(idx[-1])
            items = [self[i] for i in idx]
            yield {
                "source_image": np.stack([it["source_image"] for it in items]),
                "source_padded": np.stack([it["source_padded"] for it in items]),
                "hw": np.stack([it["hw"] for it in items]),
                "paths": [it["path"] for it in items],
                "count": count,
            }
