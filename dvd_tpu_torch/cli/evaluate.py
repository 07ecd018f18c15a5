"""Offline metric evaluation over saved dewarped PNGs (port of
``dvd_tpu/cli/evaluate.py``; the reference's MATLAB ``run_benchmark.m`` /
``run_docunet.m`` without MATLAB or the SIFTflow toolbox).

Usage:
  python -m dvd_tpu_torch.cli.evaluate \
      --pred vis_hp/docunet/exp1/dewarped_pred --gt /data/docunet/scan \
      --out results.json

Pairing follows the DocUNet convention (``run_benchmark.m:28-40``): the
leading integer of each prediction filename selects the GT scan
(``{k}.png`` in the GT directory); each scan has two photographed
crops ("k_1 copy", "k_2 copy").
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional


def leading_int(name: str) -> Optional[int]:
    m = re.search(r"(\d+)", name)
    return int(m.group(1)) if m else None


def _eval_one(job):
    """(pred_path, gt_path, name, area, backend) -> metric row.
    Top-level so a spawn-context process pool can pickle it."""
    import cv2

    from dvd_tpu_torch.evaluation import metrics as M

    pred_path, gt_path, name, area, backend = job
    pred = cv2.imread(pred_path)[:, :, ::-1]
    gt = cv2.imread(gt_path)[:, :, ::-1]
    row = M.evaluate_pair(pred, gt, protocol_area=area,
                          flow_backend=backend)
    row["file"] = name
    return row


def main(argv=None):
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pred", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--area", type=float, default=598400.0,
                    help="protocol resize area (run_docunet.m:14); 0 disables")
    ap.add_argument("--workers", type=int, default=8,
                    help="parallel evaluation processes (the MATLAB "
                         "reference uses parfor(8), run_benchmark.m:4)")
    ap.add_argument("--flow_backend", default="auto",
                    choices=("auto", "native", "dis"),
                    help="dense-registration engine for LD/AD")
    a = ap.parse_args(argv)

    gt_index = {}
    for f in os.listdir(a.gt):
        k = leading_int(f)
        if k is not None:
            gt_index.setdefault(k, os.path.join(a.gt, f))

    jobs = []
    for f in sorted(os.listdir(a.pred)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        k = leading_int(f)
        if k is None or k not in gt_index:
            print(f"skip {f}: no GT match")
            continue
        jobs.append((os.path.join(a.pred, f), gt_index[k], f,
                     a.area or None, a.flow_backend))

    rows = []
    if a.workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(a.workers, len(jobs))) as pool:
            rows = pool.map(_eval_one, jobs)
    else:
        rows = [_eval_one(j) for j in jobs]
    for r in rows:
        print(f"{r['file']}: ms_ssim={r['ms_ssim']:.4f} "
              f"ld={r['ld']:.3f} ad={r['ad']:.4f}")

    if not rows:
        raise SystemExit("no evaluable pairs found")
    summary = {
        "count": len(rows),
        "ms_ssim": float(np.mean([r["ms_ssim"] for r in rows])),
        "ld": float(np.mean([r["ld"] for r in rows])),
        "ad": float(np.mean([r["ad"] for r in rows])),
        "per_image": rows,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "per_image"}))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
