"""Single-image dewarp with the PyTorch/CUDA port (the counterpart of
``run_sampling.py --image``).

    python -m dvd_tpu_torch.cli.run_sampling --image page.png --out out.png \\
        [--seed 42] [--set model.compute_dtype=float32] [--device cuda]

Writes the unwarped image and ``<out>.coords.npy`` (the (S, S, 2) flow).
Weights are drawn from ``--seed`` (loading converted checkpoints is not
ported yet).  PIL is imported only by ``main`` to read and write files;
:func:`dewarp_image` takes and returns numpy arrays.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dvd_tpu_torch.config import DvDConfig, default_config
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed


def parse_overrides(pairs) -> dict:
    """``section.key=value`` pairs -> {section: {key: value}}."""
    out: dict = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        sec, _, field = key.partition(".")
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        out.setdefault(sec, {})[field] = val
    return out


def resize_like_pil(img: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, 3) float in [0, 255] -> (size, size, 3), as
    ``PIL.Image.resize(BILINEAR)`` on uint8: antialiased bilinear, rounded
    to integers."""
    x = img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).round().clamp(0, 255)


@torch.inference_mode()
def dewarp_image(pipe: DewarpPipeline, image: np.ndarray, seed: int,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) page photo with values in [0, 255] -> (unwarped (H, W, 3)
    float32 in [0, 255], flow (S, S, 2))."""
    ori = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))
    ori = ori.to(pipe.device)
    src = resize_like_pil(ori, pipe.cfg.model.source_size)[None] / 255.0
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    flow = pipe.dewarp_flow(src, generator=gen)
    out = unwarp_fixed(ori[None], flow)
    return out[0].cpu().numpy(), flow[0].cpu().numpy()


def build_pipeline(cfg: DvDConfig, seed: int,
                   device: str = "cuda") -> DewarpPipeline:
    """Pipeline with weights drawn from ``seed`` (on the CPU, so the same
    seed gives the same weights on any device)."""
    return DewarpPipeline.create(
        cfg, device, generator=torch.Generator().manual_seed(seed))


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--image", required=True, help="input photo")
    ap.add_argument("--out", default=None,
                    help="output path (default vis_hp/single/warped_<name>)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="K=V", help="config override, e.g. "
                    "model.compute_dtype=float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "twins of the kernels)")
    args = ap.parse_args(argv)

    from PIL import Image

    cfg = default_config().replace(**parse_overrides(args.overrides))
    pipe = build_pipeline(cfg, args.seed, args.device)
    ori = np.asarray(Image.open(args.image).convert("RGB"))
    out, flow = dewarp_image(pipe, ori, args.seed)
    out_path = args.out or os.path.join(
        "vis_hp", "single", f"warped_{os.path.basename(args.image)}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(np.clip(out, 0, 255).astype(np.uint8)).save(out_path)
    np.save(out_path + ".coords.npy", flow)
    print(f"wrote {out_path} (+ .coords.npy)")


if __name__ == "__main__":
    main()
