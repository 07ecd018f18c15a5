"""Key-value metrics logger (port of ``dvd_tpu/utils/logger.py``; the
reference's OpenAI-baselines logger surface).

``logkv``/``logkv_mean``/``dumpkvs``, a human-readable stdout table, CSV
and JSONL writers and per-quartile loss keys.  Under ``torch.distributed``
``dumpkvs`` is a collective: each key's mean is weighted by its count over
every rank (:func:`multihost_weighted_means`, the reference's
``mpi_weighted_mean``), and only a logger given formats writes (rank 0's,
in training).
"""

from __future__ import annotations

import csv
import json
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist


def multihost_weighted_means(means: Dict[str, tuple]) -> Dict[str, float]:
    """Count-weighted means of ``{key: (sum, count)}`` over every rank
    (reference ``logger.py:413-440``).  Key sets may differ between ranks
    (the quartile keys follow each rank's timesteps), so the dicts travel
    through ``all_gather_object``.  One process: the local means, no
    collective.  Every rank must call it at the same point."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return {k: s / n for k, (s, n) in means.items() if n}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, dict(means))
    acc: Dict[str, list] = {}
    for part in gathered:
        for k, (s, n) in part.items():
            a = acc.setdefault(k, [0.0, 0])
            a[0] += s
            a[1] += n
    return {k: s / n for k, (s, n) in acc.items() if n}


class KVLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 formats: tuple = ("stdout", "csv", "jsonl")):
        self.log_dir = log_dir
        self.formats = formats
        self._vals: Dict[str, float] = {}
        self._means: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        self._csv_path = None
        self._csv_keys: list = []
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            if "csv" in formats:
                self._csv_path = os.path.join(log_dir, "progress.csv")
            if "jsonl" in formats:
                self._jsonl = open(os.path.join(log_dir, "progress.jsonl"),
                                   "a")

    def logkv(self, key: str, val) -> None:
        self._vals[key] = float(val)

    def logkv_mean(self, key: str, val) -> None:
        m = self._means[key]
        m[0] += float(val)
        m[1] += 1

    def dumpkvs(self, step: Optional[int] = None) -> Dict[str, float]:
        out = dict(self._vals)
        out.update(multihost_weighted_means(
            {k: (s, n) for k, (s, n) in self._means.items() if n}))
        self._vals.clear()
        self._means.clear()
        if not out:
            return out
        if step is not None:
            out.setdefault("step", step)
        if "stdout" in self.formats:
            width = max(len(k) for k in out)
            lines = ["-" * (width + 22)]
            lines += [f"| {k:<{width}} | {out[k]:<15.6g} |" for k in sorted(out)]
            lines.append("-" * (width + 22))
            print("\n".join(lines), flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(out) + "\n")
            self._jsonl.flush()
        if self._csv_path:
            self._write_csv(out)
        return out

    def _write_csv(self, row: Dict[str, float]) -> None:
        if not self._csv_keys and os.path.isfile(self._csv_path):
            # a resumed run appending to an earlier run's file: adopt its
            # header so the rewrite below never drops columns
            with open(self._csv_path, newline="") as f:
                self._csv_keys = list(next(csv.reader(f), None) or [])
        new_keys = [k for k in row if k not in self._csv_keys]
        if new_keys:
            self._csv_keys.extend(sorted(new_keys))
            rows = []
            if os.path.isfile(self._csv_path):
                with open(self._csv_path) as f:
                    rows = list(csv.DictReader(f))
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_keys)
                w.writeheader()
                w.writerows(rows)
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_keys)
            w.writerow({k: row.get(k, "") for k in self._csv_keys})

    def log(self, *args) -> None:
        print(*args, flush=True)


def log_loss_quartiles(logger: KVLogger, sched_steps: int, t,
                       losses: Dict) -> None:
    """Per-timestep-quartile loss keys (reference ``train_util.py:680-688``):
    each sample's (t_i, v_i) pair adds to ``{key}_q{4*t_i//T}``.  Values
    may be per-sample arrays (B,) or scalars (broadcast over ``t``)."""
    t = np.atleast_1d(np.asarray(t))
    for key, val in losses.items():
        v = np.broadcast_to(np.asarray(val, np.float64), t.shape)
        logger.logkv_mean(key, float(v.mean()))
        for ti, vi in zip(t, v):
            logger.logkv_mean(f"{key}_q{int(4 * ti / sched_steps)}", float(vi))
