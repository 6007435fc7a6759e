"""Evaluate a trained GA3C-architecture checkpoint on the frozen suites with
the PyTorch port (the counterpart of ``scripts/eval_trained_net.py``).

Registers the ``.npz`` (from ``train_ppo_torch.py --export-params`` or
``train_ppo.py --export-params``) as a named policy, under its file's stem,
and runs the 500-case evaluation campaign at the given densities on the card
(``--device cpu`` for the CPU): each cell is ``experiments.run_suite_cell``,
the cell of ``run_full_test_suite``, and its summary row is
``summarize_stats``, the row of ``summarize_suite``; neither needs pandas,
which the card's machine may lack.  Prints the summary table; ``--out DIR``
writes it as ``DIR/<name>_summary.csv`` with the per-episode outcomes as
``DIR/<name>_outcomes.json`` (the schema of
``tests/data/torch_suite_jax_outcomes.json``), and ``--record-pickles`` the
reference's per-cell stats pickles (needs pandas).  ``--reference PATH``
holds every cell against such a record with
``experiments.compare_outcomes`` (exit code 1 if one disagrees).

Usage:
  python scripts/eval_trained_net_torch.py CKPT.npz [--agents 2 3 4 5 6 8 10]
      [--cases 500] [--out DIR] [--device cuda|cpu] [--reference PATH]
      [--record-pickles]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def evaluate_trained_net(ckpt, agents=(2, 3, 4, 5, 6, 8, 10), cases=500, device=None):
    """Register ``ckpt`` under its stem and run each agent count's cell of
    the campaign on ``device`` (None means CUDA).

    Returns ``(name, {num_agents: EpisodeBatch})``.
    """
    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.harness import experiments
    from gym_collision_avoidance_torch.harness import registry as hreg

    device = resolve_device(device)
    name = os.path.splitext(os.path.basename(ckpt))[0]
    hreg.register_trained_policy(name, ckpt)
    return name, {n: experiments.run_suite_cell(n, name, cases, device=device) for n in agents}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("--agents", nargs="+", type=int, default=[2, 3, 4, 5, 6, 8, 10])
    ap.add_argument("--cases", type=int, default=500)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reference", default=None,
                    help="outcome-record JSON to hold every cell against")
    ap.add_argument("--record-pickles", action="store_true",
                    help="also write <out>/<N>_agents/stats/stats_<name>.p (needs pandas and "
                         "--out)")
    args = ap.parse_args(argv)
    if args.record_pickles:
        if args.out is None:
            ap.error("--record-pickles needs --out")
        try:
            import pandas  # noqa: F401
        except ImportError:
            print("--record-pickles needs pandas, which is not installed", file=sys.stderr)
            return 2

    from gym_collision_avoidance_torch.harness import experiments

    reference = experiments.load_outcome_records(args.reference) if args.reference else None
    name, runs = evaluate_trained_net(args.ckpt, args.agents, args.cases, args.device)
    records = {n: experiments.cell_record(n, name, run.stats) for n, run in runs.items()}
    rows = [{"num_agents": n, "policy": name, **r["summary"]} for n, r in records.items()]
    print("\n".join(experiments.summary_table(rows)))
    all_ok = True
    if reference is not None:
        for n, record in records.items():
            cmp = experiments.compare_outcomes(reference[(n, name)], record)
            print(json.dumps({"num_agents": n, "policy": name, "reference": cmp}))
            all_ok &= cmp["ok"]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        experiments.write_summary_csv(os.path.join(args.out, f"{name}_summary.csv"), rows)
        with open(os.path.join(args.out, f"{name}_outcomes.json"), "w") as f:
            json.dump({"generator": "scripts/eval_trained_net_torch.py",
                       "package": "gym_collision_avoidance_torch", "dtype": "float32",
                       "config": "EnvConfig.evaluate", "cells": list(records.values())}, f,
                      separators=(",", ":"))
        if args.record_pickles:
            for n, run in runs.items():
                experiments.write_stats_pickle(experiments.stats_frame(run.stats, name),
                                               args.out, n, name)
    if not all_ok:
        print("a cell disagrees with the reference beyond its limits", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
