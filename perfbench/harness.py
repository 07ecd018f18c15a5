"""The harness's shared parts: the manifest and a cell's files, seeds,
the card check, host-clock spans and kernel-call records patched in from
outside the program, the per-layer readers, the judgement of the checked
numbers, and the import guard."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dvd_tpu")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % (2 ** 63)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since the
    harness was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell: its manifest entry and the files it names."""

    name: str
    chips: int
    config_name: str
    config: dict          # perfbench/configs/<config>.json
    traffic_name: str
    traffic: dict         # perfbench/traffic/<traffic>.json
    limits: dict          # perfbench/workloads/<cell>.json "limits"
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=conf["name"], config=load_json(ROOT / conf["file"]),
                traffic_name=entry["traffic"],
                traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(HERE / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=layer)


def traffic_module(kind: str):
    return importlib.import_module(f"perfbench.traffic.{kind}")


def program_config(config: dict, over: Optional[dict] = None):
    """The served package's config: its defaults with the configuration
    file's sections (and ``over``, section by section) applied."""
    from dvd_tpu_torch.config import default_config

    sections = {k: dict(config.get(k, {})) for k in
                ("model", "diffusion", "train", "data", "paths")}
    for k, v in (over or {}).items():
        sections[k].update(v)
    return default_config().replace(**{k: v for k, v in sections.items() if v})


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------- spans
class Spans:
    """Host-clock spans and profiler ranges wrapped around calls into the
    program.  ``mode``: "off" (calls pass through), "annotate" (a
    ``record_function`` range per call, named ``perfbench.stage.<name>``
    or, for kernels, ``perfbench.<name>``; nothing synchronises) or
    "sync" (the device synchronised before and after each call, and the
    host time kept per name)."""

    def __init__(self, device):
        self.device = device
        self.mode = "off"
        self.seconds: Dict[str, List[float]] = {}
        self.calls: Dict[str, List[tuple]] = {}

    def stage(self, name: str, fn: Callable) -> Callable:
        from torch.profiler import record_function

        def wrapped(*a, **k):
            if self.mode == "annotate":
                with record_function(f"perfbench.stage.{name}"):
                    return fn(*a, **k)
            if self.mode == "sync":
                sync(self.device)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                sync(self.device)
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)
                return out
            return fn(*a, **k)

        return wrapped

    def kernel(self, name: str, fn: Callable, cost: Callable) -> Callable:
        """A kernel call: under "annotate" its range and its (operations,
        bytes) from ``cost(*args)``."""
        from torch.profiler import record_function

        def wrapped(*a, **k):
            if self.mode != "annotate":
                return fn(*a, **k)
            self.calls.setdefault(name, []).append(cost(*a, **k))
            with record_function(f"perfbench.{name}"):
                return fn(*a, **k)

        return wrapped

    def waited(self, name: str, it):
        """Iterate ``it``, keeping under "sync" the host time each item
        took to arrive."""
        it = iter(it)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            if self.mode == "sync":
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)
            yield item


def patch_kernels(spans: Spans) -> Callable[[], None]:
    """Record K1 and K2 calls where the models make them
    (``models/layers.py``'s ``attention`` and ``conv3x3``); returns the
    function that undoes it."""
    from dvd_tpu_torch.models import layers

    from perfbench import arith

    def k1_cost(q, k, v, scale=None):
        return arith.attention_cost(q.shape, k.shape, q.element_size())

    def k2_cost(x, w, *rest, **kw):
        return arith.conv3x3_cost(x.shape, w.shape[0], x.element_size())

    saved = (layers.attention, layers.conv3x3)
    layers.attention = spans.kernel("k1", layers.attention, k1_cost)
    layers.conv3x3 = spans.kernel("k2", layers.conv3x3, k2_cost)

    def undo():
        layers.attention, layers.conv3x3 = saved

    return undo


@contextlib.contextmanager
def profiled(spans: Spans):
    """A profiled stretch: ``torch.profiler`` over the CPU and the card,
    the stretch marked as the ``perfbench.window`` range, the spans in
    "annotate" mode.  Yields a dict that holds the profile afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    sync(spans.device)
    spans.mode = "annotate"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("perfbench.window"):
            t0 = time.perf_counter()
            yield out
            sync(spans.device)
            out["host_s"] = time.perf_counter() - t0
    spans.mode = "off"
    out["prof"] = prof


def model_flops(fn: Callable) -> float:
    """Operations ``fn()`` performs, counted by ``FlopCounterMode``
    (matmuls, convolutions, attention)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


# ------------------------------------------------------------- readers
def reader(name: str) -> Callable[[dict], Optional[float]]:
    """The ``read(rec)`` of the metric's reader
    ``perfbench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_layer_metrics(cell: Cell, rec: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader (``reader``); a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(rec)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def mean_ms(seconds: Optional[List[float]]):
    return 1e3 * statistics.fmean(seconds) if seconds else None


# ----------------------------------------------------------- judgement
def judge(checks: Dict[str, float], limits: Dict[str, float]):
    """(correct, the checks beside their limits): every number at or
    under its limit; a missing or non-finite number (reported as null) is
    not correct."""
    rows, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = checks.get(name)
        finite = value is not None and math.isfinite(value)
        ok = ok and finite and value <= limit
        rows[name] = {"value": value if finite else None, "limit": limit}
    return ok, rows


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
