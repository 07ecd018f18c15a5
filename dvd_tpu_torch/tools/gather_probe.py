"""Probe K5, the exact integer 2-D gather, at the case of
``tools/pallas_gather_probe.py``: a (64, 256) ``arange`` image gathered at
(8, 128) int32 indices drawn in [13, 36) x [100, 230).

    python -m dvd_tpu_torch.tools.gather_probe [--device cpu]

Prints ``max_err`` against plain ``img[y, x]`` and ``PRIMITIVES_OK``, and
raises unless the error is exactly 0.  On the card the gather is K5; with
``--device cpu`` it is K5's plain twin.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from dvd_tpu_torch.ops.kernels.gather2d import gather2d

H, W = 64, 256


def probe_inputs():
    """(image, y, x) on the CPU: the probe's image and its index window,
    drawn from a seeded ``torch.Generator``."""
    img = torch.arange(H * W, dtype=torch.float32).reshape(H, W)
    gen = torch.Generator().manual_seed(0)
    y = torch.randint(13, 36, (8, 128), generator=gen, dtype=torch.int32)
    x = torch.randint(100, 230, (8, 128), generator=gen, dtype=torch.int32)
    return img, y, x


def run_probe(device="cuda") -> float:
    """Gather on ``device`` and return the max abs error against
    ``img[y, x]``; raises unless it is exactly 0."""
    img, y, x = probe_inputs()
    dev = torch.device(device)
    out = gather2d(img.to(dev), y.to(dev), x.to(dev)).cpu()
    err = (out - img[y.long(), x.long()]).abs().max().item()
    print("max_err", err)
    if err != 0.0:
        raise AssertionError(f"MISMATCH: max_err {err}")
    print("PRIMITIVES_OK")
    return err


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the twin)")
    args = ap.parse_args(argv)
    run_probe(args.device)


if __name__ == "__main__":
    main()
