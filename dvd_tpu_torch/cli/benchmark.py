"""One-command benchmark protocol: dataset root -> dewarped PNGs ->
MS-SSIM/LD/AD table (port of ``dvd_tpu/cli/benchmark.py``; serving
through the port's ``run_from_config`` / ``run_benchmark`` on the card
unless ``--device cpu``).

Replaces the reference's two-step workflow — ``run_sampling.py`` to
write ``vis_hp/.../dewarped_pred/warped_*.png``, then MATLAB
``matlab_code/run_benchmark.m:28-62`` over the pairing convention
(``{k}_{m} copy`` crops vs ``scan/{k}.png`` GTs) — with a single
invocation that drives sampling and metrics end to end.

Usage:
  python -m dvd_tpu_torch.cli.benchmark \
      --dataset /data/docunet/crop --gt /data/docunet/scan \
      --name exp1 [--set paths.model_path=weights.msgpack] [--device cuda]

Output (in the prediction directory, mirroring run_benchmark.m:62):
  * ``adres.txt``   — ASCII matrix, one row per (k, m) pair:
                      ``k  m  ad  ms_ssim  ld`` (failures as -1), with a
                      trailing row holding the mean over valid rows —
                      the exact shape MATLAB's ``save -ascii`` emits.
  * ``adres.json``  — the same data plus run stats, machine-readable.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import warnings
from typing import List, Optional, Tuple


# Anchored filename patterns, tried in order (a loose first-two-integers
# rule mis-pairs names with incidental leading digits).  Each entry: (compiled pattern over the stem, (k_group, m_group)).
_PAIR_PATTERNS = [
    # AnyPhotoDoc 5-int names `x_a_b_k_m[_geo]` — k/m are the 4th/5th ints
    # (run.m:55 `warped_(\d+)_(\d+)_(\d+)_(\d+)_(\d+).png`; run_50.m /
    # run_100.m construct `{x}_{a}_{b}_{k}_{m}.jpg`).
    (re.compile(r"^(?:warped_)?(\d+)_(\d+)_(\d+)_(\d+)_(\d+)(?:_geo)?$"),
     (3, 4)),
    # DocUNet/DocReal: `warped_{k}_{m} copy` (run_benchmark.m:40),
    # `{k}_{m} copy_rec` (run_docunet.m:41 / run_docreal.m:41), plus the
    # commented alternates `{k}_{m}[_geo|_rec|_unwarp]` and plain `{k}_{m}`.
    (re.compile(r"^(?:warped_)?(\d+)_(\d+)"
                r"(?: copy)?(?:_geo|_rec|_unwarp)?$"), (0, 1)),
    (re.compile(r"^warped_img_(\d+)$"), (0, None)),
    (re.compile(r"^(\d+)$"), (0, None)),        # GT scans: `{k}.png`/`%02d.png`
]


def pair_key(name: str) -> Optional[Tuple[int, int]]:
    """(k, m) from a prediction/GT filename.

    Tries the reference runners' anchored patterns first; falls back to
    the *last* two integers (the ``{k}_{m}`` suffix convention survives
    prefixed resolution/step counts, e.g. ``out512_3_1.png`` -> (3, 1)).
    """
    stem = os.path.splitext(name)[0]
    for pat, (ki, mi) in _PAIR_PATTERNS:
        mobj = pat.match(stem)
        if mobj:
            g = mobj.groups()
            return int(g[ki]), (int(g[mi]) if mi is not None else 0)
    ints = re.findall(r"\d+", stem)
    if not ints:
        return None
    if len(ints) == 1:
        return int(ints[0]), 0
    # Heuristic territory: no anchored runner pattern matched.  Say so —
    # a silent mis-pair corrupts the whole table.  warnings
    # rather than print: pooled workers capture stdout, and warnings
    # dedupe per-callsite instead of spamming one line per file.
    warnings.warn(
        f"pair_key fallback for '{name}': taking last two integers "
        f"({ints[-2]}, {ints[-1]}); rename to a runner convention "
        f"(warped_{{k}}_{{m}}.png) if this pairing is wrong",
        stacklevel=2)
    return int(ints[-2]), int(ints[-1])


def _metric_row(job):
    """Top-level for spawn-context pools.  Returns [k, m, ad, ms, ld]
    with -1 sentinels on failure (run_benchmark.m:44-49 catch block)."""
    pred_path, gt_path, k, m, area, backend = job
    try:
        import cv2

        from dvd_tpu_torch.evaluation import metrics as M

        pred = cv2.imread(pred_path)
        gt = cv2.imread(gt_path)
        if pred is None or gt is None:
            raise IOError("unreadable image")
        r = M.evaluate_pair(pred[:, :, ::-1], gt[:, :, ::-1],
                            protocol_area=area, flow_backend=backend)
        return [float(k), float(m), r["ad"], r["ms_ssim"], r["ld"]]
    except Exception as e:  # noqa: BLE001 — parity with the parfor catch
        print(f"eval failed for {os.path.basename(pred_path)}: {e}")
        return [float(k), float(m), -1.0, -1.0, -1.0]


def evaluate_predictions(pred_dir: str, gt_dir: str, *,
                         area: Optional[float] = 598400.0,
                         workers: int = 8,
                         flow_backend: str = "auto") -> dict:
    """Score every prediction in ``pred_dir`` against ``gt_dir`` and
    write ``adres.txt`` / ``adres.json`` next to the predictions."""
    import numpy as np

    gt_index = {}
    for f in sorted(os.listdir(gt_dir)):
        key = pair_key(f)
        if key is not None:
            gt_index.setdefault(key[0], os.path.join(gt_dir, f))

    jobs = []
    for f in sorted(os.listdir(pred_dir)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        key = pair_key(f)
        if key is None or key[0] not in gt_index:
            print(f"skip {f}: no GT with index {key and key[0]}")
            continue
        jobs.append((os.path.join(pred_dir, f), gt_index[key[0]],
                     key[0], key[1], area or None, flow_backend))
    if not jobs:
        raise SystemExit(f"no evaluable (pred, gt) pairs under {pred_dir}")

    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
            rows = pool.map(_metric_row, jobs)
    else:
        rows = [_metric_row(j) for j in jobs]

    # run_benchmark.m:58 filters `res(:,3) > 0`; failures are tagged -1 so
    # >= 0 is the same predicate without dropping a perfect (ad == 0) pair
    res = np.asarray(sorted(rows), np.float64)
    valid = res[res[:, 2] >= 0]
    if len(valid) == 0:
        raise SystemExit("every pair failed evaluation")
    table = np.concatenate([res, valid.mean(0, keepdims=True)], 0)

    # run_benchmark.m:62 `save -ascii`: space-separated %.7e rows
    txt_path = os.path.join(pred_dir, "adres.txt")
    np.savetxt(txt_path, table, fmt="%.7e")
    summary = {
        "count": int(len(valid)),
        "failed": int(len(res) - len(valid)),
        "ms_ssim": float(valid[:, 3].mean()),
        "ld": float(valid[:, 4].mean()),
        "ad": float(valid[:, 2].mean()),
        "rows": [[float(v) for v in r] for r in table],
    }
    with open(os.path.join(pred_dir, "adres.json"), "w") as f:
        json.dump(summary, f, indent=2)

    print(f"{'k':>4} {'m':>2} {'ad':>8} {'ms_ssim':>8} {'ld':>8}")
    for r in table[:-1]:
        print(f"{int(r[0]):>4} {int(r[1]):>2} {r[2]:8.4f} {r[3]:8.4f} "
              f"{r[4]:8.3f}")
    print(f"mean ({len(valid)}/{len(res)} valid): "
          f"ad={summary['ad']:.4f} ms_ssim={summary['ms_ssim']:.4f} "
          f"ld={summary['ld']:.3f}")
    print(f"wrote {txt_path}")
    return summary


def run(cfg, gt_dir: str, *, seed: int = 42, workers: int = 8,
        area: Optional[float] = 598400.0, flow_backend: str = "auto",
        device: str = "cuda") -> dict:
    """Sample the eval dataset under ``cfg`` on ``device``, then score the
    outputs."""
    from dvd_tpu_torch.evaluation.driver import run_from_config

    out_dir = os.path.join("vis_hp", cfg.data.eval_dataset_name, cfg.name)
    pred_dir = os.path.join(out_dir, "dewarped_pred")
    stats = run_from_config(cfg, seed=seed, device=device)
    print(f"sampling: {stats['images']} images at "
          f"{stats['imgs_per_sec']} imgs/sec")
    summary = evaluate_predictions(pred_dir, gt_dir, area=area,
                                   workers=workers,
                                   flow_backend=flow_backend)
    return summary


def _category_dirs(root: str) -> List[str]:
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def evaluate_categories(pred_root: str, gt_root: str, *,
                        area: Optional[float] = 598400.0,
                        workers: int = 8,
                        flow_backend: str = "auto") -> dict:
    """Per-category benchmark reporting (the AnyPhotoDoc protocol).

    The reference scores each layout category with a separate MATLAB run
    — one (gtdir, imdir) pair per invocation of ``matlab_code/run.m`` /
    ``run_50.m`` / ``run_100.m``, where gtdir is a category folder
    (single_column, two_column, three_more_columns, commercial_invoice,
    education, book, sparse_text, consumption_receipt) — and the paper
    reports per-category means.  Here one call walks every matching
    ``{gt_root}/{cat}`` vs ``{pred_root}/{cat}`` pair, writes the usual
    adres.txt/adres.json *inside each category's prediction dir*, and an
    aggregate ``adres_categories.json`` (+ printed table) at the root.
    """
    cats = _category_dirs(gt_root)
    if not cats:
        raise SystemExit(f"no category subdirectories under {gt_root}")
    per_cat = {}
    for cat in cats:
        pred_dir = os.path.join(pred_root, cat)
        if not os.path.isdir(pred_dir):
            print(f"skip category {cat}: no predictions at {pred_dir}")
            continue
        print(f"— category {cat} —")
        try:
            per_cat[cat] = evaluate_predictions(
                pred_dir, os.path.join(gt_root, cat), area=area,
                workers=workers, flow_backend=flow_backend)
        except SystemExit as e:
            # an empty/failed category must not abort the other runners'
            # categories (each is a separate MATLAB invocation upstream)
            print(f"category {cat} failed: {e}")
    if not per_cat:
        raise SystemExit("no category had predictions")

    total = sum(s["count"] for s in per_cat.values())
    overall = {k: sum(s[k] * s["count"] for s in per_cat.values()) / total
               for k in ("ms_ssim", "ld", "ad")}
    report = {
        "categories": {c: {k: s[k] for k in
                           ("count", "failed", "ms_ssim", "ld", "ad")}
                       for c, s in per_cat.items()},
        "overall": {**overall, "count": total},
    }
    with open(os.path.join(pred_root, "adres_categories.json"), "w") as f:
        json.dump(report, f, indent=2)

    name_w = max(len(c) for c in per_cat) + 2
    print(f"\n{'category':<{name_w}} {'n':>4} {'ms_ssim':>8} {'ld':>8} "
          f"{'ad':>8}")
    for c, s in per_cat.items():
        print(f"{c:<{name_w}} {s['count']:>4} {s['ms_ssim']:8.4f} "
              f"{s['ld']:8.3f} {s['ad']:8.4f}")
    print(f"{'overall':<{name_w}} {total:>4} {overall['ms_ssim']:8.4f} "
          f"{overall['ld']:8.3f} {overall['ad']:8.4f}")
    return report


def run_categories(cfg, dataset_root: str, gt_root: str, *, seed: int = 42,
                   workers: int = 8, area: Optional[float] = 598400.0,
                   flow_backend: str = "auto", device: str = "cuda") -> dict:
    """Sample + score every category subdir, reusing ONE pipeline across
    categories -- the per-category MATLAB protocol without paying the
    model build per category."""
    import torch

    from dvd_tpu_torch.data.benchmark import BenchmarkDataset
    from dvd_tpu_torch.evaluation.driver import run_benchmark
    from dvd_tpu_torch.evaluation.pipeline import DewarpPipeline
    from dvd_tpu_torch.training.checkpoint import maybe_load_pipeline_weights

    pipe = DewarpPipeline.create(
        cfg, device, generator=torch.Generator().manual_seed(cfg.train.seed))
    maybe_load_pipeline_weights(pipe, cfg)
    pred_root = os.path.join(
        "vis_hp", cfg.data.eval_dataset_name, cfg.name)
    for cat in _category_dirs(dataset_root):
        ds = BenchmarkDataset.from_dir(os.path.join(dataset_root, cat),
                                       source_size=cfg.model.source_size)
        stats = run_benchmark(pipe, ds, os.path.join(pred_root, cat),
                              batch_size=cfg.data.eval_device_batch,
                              seed=seed)
        print(f"category {cat}: {stats['images']} images at "
              f"{stats['imgs_per_sec']} imgs/sec")
    # predictions land in {pred_root}/{cat}/dewarped_pred; score those
    return evaluate_categories_nested(pred_root, gt_root, area=area,
                                      workers=workers,
                                      flow_backend=flow_backend)


def evaluate_categories_nested(pred_root: str, gt_root: str, **kw) -> dict:
    """Like :func:`evaluate_categories` but predictions live at
    ``{pred_root}/{cat}/dewarped_pred`` (the sampling driver's layout)."""
    import tempfile

    import shutil

    cats = _category_dirs(pred_root)
    link_root = tempfile.mkdtemp(prefix="dvd_cat_")
    try:
        any_nested = False
        for cat in cats:
            inner = os.path.join(pred_root, cat, "dewarped_pred")
            if os.path.isdir(inner):
                os.symlink(os.path.abspath(inner),
                           os.path.join(link_root, cat))
                any_nested = True
            else:
                # flat category (PNGs directly under {pred_root}/{cat}) —
                # keep it in the run even when other categories are nested
                os.symlink(os.path.abspath(os.path.join(pred_root, cat)),
                           os.path.join(link_root, cat))
        if not any_nested:  # flat layout: {pred_root}/{cat}/ holds the PNGs
            return evaluate_categories(pred_root, gt_root, **kw)
        report = evaluate_categories(link_root, gt_root, **kw)
        shutil.move(os.path.join(link_root, "adres_categories.json"),
                    os.path.join(pred_root, "adres_categories.json"))
        return report
    finally:
        shutil.rmtree(link_root, ignore_errors=True)


def main(argv=None):
    from dvd_tpu_torch.cli.run_sampling import parse_overrides

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True,
                    help="warped input images (e.g. docunet crop/)")
    ap.add_argument("--gt", required=True,
                    help="ground-truth scans (run_benchmark.m gtdir)")
    ap.add_argument("--name", default="benchmark")
    ap.add_argument("--eval_dataset_name", default="docunet")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--set", action="append", dest="overrides", metavar="K=V")
    ap.add_argument("--area", type=float, default=598400.0,
                    help="protocol resize area (run_docunet.m:14); 0 disables")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--flow_backend", default="auto",
                    choices=("auto", "native", "dis"))
    ap.add_argument("--device", default="cuda",
                    help="torch device for sampling (default cuda; 'cpu' "
                         "runs the plain twins of the kernels)")
    ap.add_argument("--skip_sampling", action="store_true",
                    help="--dataset is an existing prediction dir (e.g. "
                         "vis_hp/.../dewarped_pred); score it only")
    ap.add_argument("--per_category", action="store_true",
                    help="AnyPhotoDoc/DocReal-style per-category protocol: "
                         "--dataset and --gt hold matching category "
                         "subdirectories (matlab_code/run.m per-gtdir runs); "
                         "emits per-category means + adres_categories.json")
    a = ap.parse_args(argv)

    if a.skip_sampling:
        # the nested scorer auto-detects flat vs sampled
        # ({root}/{cat}/dewarped_pred) layouts, so --skip_sampling can
        # re-score a prior --per_category sampling run's output root
        score = (evaluate_categories_nested if a.per_category
                 else evaluate_predictions)
        score(a.dataset, a.gt, area=a.area or None, workers=a.workers,
              flow_backend=a.flow_backend)
        return

    import dataclasses

    from dvd_tpu_torch.config import default_config

    cfg = default_config()
    over = parse_overrides(a.overrides)
    over.setdefault("data", {})["eval_dataset"] = a.dataset
    over["data"]["eval_dataset_name"] = a.eval_dataset_name
    if a.batch:
        over["data"]["eval_device_batch"] = a.batch
    cfg = dataclasses.replace(cfg.replace(**over), name=a.name)

    if a.per_category:
        run_categories(cfg, a.dataset, a.gt, seed=a.seed, workers=a.workers,
                       area=a.area or None, flow_backend=a.flow_backend,
                       device=a.device)
    else:
        run(cfg, a.gt, seed=a.seed, workers=a.workers, area=a.area or None,
            flow_backend=a.flow_backend, device=a.device)


if __name__ == "__main__":
    main()
