"""Run one benchmark cell once on the card and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration, traffic
mix, limits and metric readers are files under ``perfbench/`` (see
``perfbench/README.md``).  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, then ``checks``: each checked number
beside its limit); the same checks are the last lines of standard error.
Without a card, or with fewer cards than the cell asks for, or with a JAX
module loaded at the end, it exits with a non-zero code and no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import subprocess
import sys
from typing import Optional

from perfbench import harness
from perfbench.harness import ROOT, Cell
from perfbench.trace import read as read_trace

CACHE = ROOT / ".perfbench_cache"


@dataclasses.dataclass
class Context:
    """What a traffic kind's ``run(ctx)`` is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    over: Optional[dict] = None     # program config overrides (controls)
    controls: bool = False          # also read the reference-side controls

    @staticmethod
    def age() -> float:
        return harness.process_age_s()


def card_lines(device) -> list:
    import torch

    lines = []
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
        lines.append(f"card: {smi}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"card: nvidia-smi unavailable ({e})")
    lines.append(f"torch {torch.__version__} cuda {torch.version.cuda}; "
                 f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
                 f"cudnn={torch.backends.cudnn.allow_tf32}")
    cpu = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f
                        if ln.startswith("model name")), cpu)
    except OSError:
        pass
    lines.append(f"host: {cpu}, {os.cpu_count()} cpus")
    return lines


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             over: Optional[dict] = None, controls: bool = False) -> dict:
    """Run the cell and return its result object (not printed); with
    ``controls`` every number the check read is under ``raw_checks``, and
    the control's numbers, read in the program's place, under
    ``control_checks`` with their verdict ``control_correct``."""
    import torch

    device = torch.device(device)
    ctx = Context(cell, int(seed), float(seconds), bool(trace), device, over,
                  controls)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rec = harness.traffic_module(cell.kind).run(ctx)
    prof = (rec.get("profile") or {}).get("prof")
    if trace and prof is not None:
        rec["trace"] = read_trace(prof, ranges=("perfbench.k1",
                                                "perfbench.k2"))
    correct, checks = harness.judge(rec["checks"], cell.limits)
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"]}
    names = cell.per_layer if trace else cell.end_to_end
    metrics = harness.read_layer_metrics(
        dataclasses.replace(cell, per_layer=names), rec)
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else platform.processor(),
           "count": cell.chips,
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    seen = rec.get("trace") or {}
    if trace and seen:
        dev["busy_s"] = seen["busy_s"]
        dev["window_s"] = seen["window_s"]
        result["breakdown"] = {"device_ops": seen["device_ops"],
                               "idle_gaps": seen["idle_gaps"]}
    result["device"] = dev
    if controls:
        result["raw_checks"] = rec["checks"]
        if rec.get("control_checks") is not None:
            result["control_correct"], result["control_checks"] = \
                harness.judge(rec["control_checks"], cell.limits)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    for line in card_lines("cuda"):
        print(line, file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0")
    bad = harness.loaded_forbidden()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
