"""Readings for the limits of a serving cell's checked numbers, each seed a
whole run at the cell's own sizes with a short window, several seeds in
one process.  The benchmark's own runs never run this.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--control fp8|int8]

- ``fp8`` (the default): the program as configured, and in its place the
  reference computed a precision below (every product of the
  conditioning and the DDIM loop on float8 operands, the unwarp in
  bfloat16), judged against the cell's limits under the same names.
- ``int8``: the program with its own int8 serving path switched on, the
  precision below the configured bf16.

One JSON line per seed: {"seed", "control", "correct", "checks"} of the
control, judged by ``harness.judge`` against the cell's limits, and with
``fp8`` {"program": {"correct", "checks"}}, the program's own run.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import harness
from perfbench.run import card_lines, run_cell

INT8 = {"model": {"quantize": "int8"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", choices=("fp8", "int8"), default="fp8")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    for line in card_lines("cuda"):
        print(line, file=sys.stderr)
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.control == "int8":
            res = run_cell(cell, seed, args.seconds, False, "cuda:0",
                           over=INT8)
            line = {"correct": res["correct"],
                    "checks": {k: v["value"] for k, v in
                               res["checks"].items()}}
        else:
            res = run_cell(cell, seed, args.seconds, False, "cuda:0",
                           controls=True)
            line = {"correct": res["control_correct"],
                    "checks": {k: v["value"] for k, v in
                               res["control_checks"].items()},
                    "program": {"correct": res["correct"],
                                "checks": res["raw_checks"]}}
        print(json.dumps({"seed": seed, "control": args.control, **line,
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
