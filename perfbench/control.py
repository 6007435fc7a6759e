"""Readings for the comparison's limits: a cell's sound runs and its
lower-precision control, on many seeds in one process.

    python3 perfbench/control.py --workload cadrl4.serve16k --seeds 11,12,13 \\
        --seconds 16 --control bf16_weights --sound 1 --faults half,unchanged

For each seed it runs the cell as the benchmark does (``--sound 1``),
with ``--control tf32`` again with TF32 products switched on (the program's
own lower-precision path; ``bf16_weights`` rounds the net's weights to
bfloat16 instead), and with each of ``--faults`` (``perfbench/
faults.py``) planted in the program, and prints one JSON line a run with
the compared numbers.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import faults, run  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", default="", help="tf32, bf16_weights, or empty for none")
    parser.add_argument("--sound", type=int, default=1, help="also run the sound program")
    parser.add_argument("--faults", default="", help="comma-separated faults to plant")
    args = parser.parse_args(argv)
    kind = run.load_cell(args.workload)["traffic"]["kind"]
    modes = (([("", "")] if args.sound else []) + ([(args.control, "")] if args.control else [])
             + [("", f) for f in args.faults.split(",") if f])
    for seed in (int(s) for s in args.seeds.split(",")):
        for control, fault in modes:
            with faults.planted(kind, fault) if fault else contextlib.nullcontext():
                line = run.run_cell(args.workload, seed, args.seconds, False,
                                    t_start=time.perf_counter(), control=control)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control or fault or "none", "correct": line["correct"],
                              "readings": {k: c["value"] for k, c in line["check"].items()},
                              "metrics": {k: m["value"] for k, m in line["metrics"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
