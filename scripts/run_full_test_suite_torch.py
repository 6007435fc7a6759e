"""CLI: the full evaluation campaign on the PyTorch port (the port's
counterpart of ``scripts/run_full_test_suite.py``, which mirrors the
reference's experiments/src/run_full_test_suite.py).

Runs each (agent count, policy) cell of the frozen 500-case suites as one
batch on the card (``--device cpu`` for the CPU), prints each cell's wall
seconds, lockstep steps, episodes/s, env-steps/s and summary, and writes
``<out>/summary.csv`` and ``<out>/outcomes.json`` (per-episode outcomes and
steps, the schema of ``tests/data/torch_suite_jax_outcomes.json``).
``--reference PATH`` holds every cell against such a file with
``harness/experiments.py:compare_outcomes`` (every outcome equal, step counts
equal on all but 2% of the cases), else the exit code is 1.
``--record-pickles`` also writes the reference's per-policy stats pickles,
which needs pandas.

Usage:
  python scripts/run_full_test_suite_torch.py [--policies CADRL RVO GA3C-CADRL-10]
      [--agents 2 3 4] [--cases 500] [--out results/full_test_suites_torch]
      [--device cuda|cpu] [--reference tests/data/torch_suite_jax_outcomes.json]
      [--record-pickles]
"""

import argparse
import csv
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SUMMARY_COLUMNS = ("num_agents", "policy", "pct_collision", "pct_stuck", "pct_success",
                   "mean_extra_time_to_goal", "p90_extra_time_to_goal")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policies", nargs="+", default=["CADRL", "RVO", "GA3C-CADRL-10"])
    ap.add_argument("--agents", nargs="+", type=int, default=[2, 3, 4])
    ap.add_argument("--cases", type=int, default=500)
    ap.add_argument("--out", default="results/full_test_suites_torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reference", default=None,
                    help="outcome-record JSON to hold every cell against")
    ap.add_argument("--record-pickles", action="store_true",
                    help="also write <out>/<N>_agents/stats/stats_<policy>.p (needs pandas)")
    args = ap.parse_args(argv)

    if args.record_pickles:
        try:
            import pandas  # noqa: F401
        except ImportError:
            print("--record-pickles needs pandas, which is not installed", file=sys.stderr)
            return 2

    import torch

    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.harness import experiments

    device = resolve_device(args.device)
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    reference = experiments.load_outcome_records(args.reference) if args.reference else None
    os.makedirs(args.out, exist_ok=True)

    rows, cells, all_ok = [], [], True
    for num_agents in args.agents:
        for policy in args.policies:
            t0 = time.perf_counter()
            run = experiments.run_suite_cell(num_agents, policy, args.cases, device=device)
            seconds = time.perf_counter() - t0
            stats, steps = run.stats, run.lockstep_steps
            record = experiments.cell_record(num_agents, policy, stats)
            line = {"num_agents": num_agents, "policy": policy, "device": kind,
                    "episodes": len(stats), "seconds": seconds, "lockstep_steps": steps,
                    "episodes_per_s": len(stats) / seconds,
                    "env_steps_per_s": len(stats) * steps / seconds,
                    **record["summary"]}
            if reference is not None:
                cmp = experiments.compare_outcomes(reference[(num_agents, policy)], record)
                line["reference"] = cmp
                all_ok &= cmp["ok"]
            print(json.dumps(line), flush=True)
            rows.append({"num_agents": num_agents, "policy": policy, **record["summary"]})
            cells.append(record)
            if args.record_pickles:
                experiments.write_stats_pickle(experiments.stats_frame(stats, policy),
                                               args.out, num_agents, policy)

    print(" ".join(f"{c:>24}" for c in SUMMARY_COLUMNS))
    for row in rows:
        print(" ".join(f"{row[c]:>24.6g}" if isinstance(row[c], float) else f"{row[c]:>24}"
                       for c in SUMMARY_COLUMNS))
    with open(os.path.join(args.out, "summary.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=SUMMARY_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    with open(os.path.join(args.out, "outcomes.json"), "w") as f:
        json.dump({"generator": "scripts/run_full_test_suite_torch.py",
                   "package": "gym_collision_avoidance_torch", "device": kind,
                   "torch_version": torch.__version__, "dtype": "float32",
                   "config": "EnvConfig.evaluate", "cells": cells}, f, separators=(",", ":"))
    print(f"wrote {args.out}/summary.csv and {args.out}/outcomes.json")
    if reference is not None and not all_ok:
        print("a cell disagrees with the reference beyond its limits", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
