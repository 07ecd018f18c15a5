"""Dewarp with the PyTorch/CUDA port (the counterpart of ``run_sampling.py``).

    # one photo -> the unwarped image + <out>.coords.npy (the (S, S, 2) flow)
    python -m dvd_tpu_torch.cli.run_sampling --image page.png --out out.png

    # a directory of photos at native resolution -> vis_hp/{ds}/{name}/
    #   dewarped_pred/warped_*.png + run_stats.json
    python -m dvd_tpu_torch.cli.run_sampling --eval_dataset DIR \
        --eval_dataset_name docunet --name exp1 [--batch 4] [--profile DIR]

    # the robustness sweep: each corruption (one id, or all) at severities
    # 1-5 -> vis_hp/{ds}/{name}_corrupt_{id}_s{1..5}/
    python -m dvd_tpu_torch.cli.run_sampling --eval_dataset DIR \
        --eval_dataset_name docunet --name exp1 --corruption gaussian_noise

    common: [--seed 42] [--set model.compute_dtype=float32]
            [--set model.quantize=int8] [--device cuda]

Weights are drawn from a seed (``--seed`` for ``--image``,
``train.seed`` for a dataset, as ``run_sampling.py``), then replaced by the
converted ``.msgpack`` files found at ``cfg.paths`` (``--set
paths.model_path=...``; see ``cli/convert_ckpt.py``); the CLI prints which
were loaded.  The sweep's weights are drawn from ``--seed``, as
``run_sampling.py``'s.  PIL and cv2 are imported only to read and write files;
:func:`dewarp_image` takes and returns numpy arrays.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dvd_tpu_torch.config import DvDConfig, default_config
from dvd_tpu_torch.data.corruptions import CorruptedDataset, corruption_names
from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline, unwarp_fixed
from dvd_tpu_torch.training.checkpoint import maybe_load_pipeline_weights


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
    seed gives the same weights on any device); the caller loads any
    converted files over them (:func:`maybe_load_pipeline_weights`)."""
    return DewarpPipeline.create(
        cfg, device, generator=torch.Generator().manual_seed(seed))


def run_corruption_sweep(pipe: DewarpPipeline, dataset, cfg: DvDConfig,
                         names, severities=(1, 2, 3, 4, 5), seed: int = 42,
                         out_root: str = "vis_hp", **run_kw) -> dict:
    """The robustness sweep (reference ``run_sampling.py:52-58``): every
    page of ``dataset`` (a ``BenchmarkDataset``) under each corruption of
    ``names`` at each of ``severities``, one ``run_benchmark`` each into
    ``{out_root}/{eval_dataset_name}/{cfg.name}_corrupt_{id}_s{severity}``,
    all on one pipeline.  ``run_kw`` goes to ``run_benchmark``.  Returns
    ``{(id, severity): stats}``."""
    from dvd_tpu_torch.evaluation.driver import run_benchmark

    results = {}
    for name in names:
        for sev in severities:
            out_dir = os.path.join(out_root, cfg.data.eval_dataset_name,
                                   f"{cfg.name}_corrupt_{name}_s{sev}")
            stats = run_benchmark(pipe, CorruptedDataset(dataset, name, sev),
                                  out_dir,
                                  batch_size=cfg.data.eval_device_batch,
                                  seed=seed, **run_kw)
            print(f"{name} s{sev}: {stats['imgs_per_sec']} imgs/sec, "
                  f"{stats['images']} images")
            results[(name, sev)] = stats
    return results


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--image", default=None,
                    help="dewarp one photo instead of a dataset")
    ap.add_argument("--out", default=None,
                    help="output path for --image (default "
                         "vis_hp/single/warped_<name>)")
    ap.add_argument("--eval_dataset", default=None,
                    help="directory of photos to dewarp at native size")
    ap.add_argument("--eval_dataset_name", default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="pages per batch (data.eval_device_batch)")
    ap.add_argument("--name", default="default")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the dataset run's "
                         "steady state to DIR")
    ap.add_argument("--corruption", default=None,
                    help="corruption-robustness sweep over --eval_dataset: "
                         "one corruption id, or 'all'")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="K=V", help="config override, e.g. "
                    "model.compute_dtype=float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "twins of the kernels)")
    args = ap.parse_args(argv)

    over = parse_overrides(args.overrides)
    data = over.setdefault("data", {})
    if args.eval_dataset:
        data["eval_dataset"] = args.eval_dataset
    if args.eval_dataset_name:
        data["eval_dataset_name"] = args.eval_dataset_name
    if args.batch:
        data["eval_device_batch"] = args.batch
    cfg = dataclasses.replace(default_config().replace(**over),
                              name=args.name)

    if args.image:
        if not os.path.isfile(args.image):
            ap.error(f"--image: no such file: {args.image}")
        from PIL import Image

        pipe = build_pipeline(cfg, args.seed, args.device)
        print(f"loaded weights: {maybe_load_pipeline_weights(pipe, cfg)}")
        ori = np.asarray(Image.open(args.image).convert("RGB"))
        out, flow = dewarp_image(pipe, ori, args.seed)
        out_path = args.out or os.path.join(
            "vis_hp", "single", f"warped_{os.path.basename(args.image)}")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        Image.fromarray(np.clip(out, 0, 255).astype(np.uint8)).save(out_path)
        np.save(out_path + ".coords.npy", flow)
        print(f"wrote {out_path} (+ .coords.npy)")
        return
    if not cfg.data.eval_dataset:
        ap.error("give --image or --eval_dataset")

    if args.corruption:
        from dvd_tpu_torch.data.benchmark import BenchmarkDataset

        names = corruption_names(args.corruption)
        pipe = build_pipeline(cfg, args.seed, args.device)
        print(f"loaded weights: {maybe_load_pipeline_weights(pipe, cfg)}")
        ds = BenchmarkDataset.from_dir(cfg.data.eval_dataset,
                                       source_size=cfg.model.source_size)
        run_corruption_sweep(pipe, ds, cfg, names, seed=args.seed)
        return

    from dvd_tpu_torch.evaluation.driver import run_from_config

    stats = run_from_config(cfg, seed=args.seed, device=args.device,
                            profile_dir=args.profile)
    print(f"Elapsed: {stats['images']} images, {stats['imgs_per_sec']} "
          f"imgs/sec (first batch {stats['compile_seconds']}s)")


if __name__ == "__main__":
    main()
