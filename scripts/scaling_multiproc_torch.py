#!/usr/bin/env python3
"""The transport boundary of the PyTorch port's distributed rollout (the
counterpart of ``scripts/scaling_multiproc.py``).

In the port every rank is one process on one device, so the JAX script's
"processes x devices a process" has no form here; what moves is the
transport.  Each point is a ``scripts/launch_multihost_torch.py --spawn R``
run in this process (the rollout of the 4-agent circle, the median of
``--reps`` windows, each the slowest rank's):

* fixed work: ``--envs`` envs, ``--steps`` steps, at each rank count of
  ``--ranks`` over gloo and, where every rank has a card of its own, over
  NCCL: the same global work and ranks, only the transport moves;
* weak scaling: ``--envs`` envs a rank from 1 rank to 2, over NCCL with two
  cards, else over gloo (the 1-rank point is the fixed-work one).

Prints one markdown table and one JSON line.  The reduced metrics' checksum
must not depend on the transport: at 1 and 2 ranks the reduction is a sum of
at most two terms, exact in any order, so ``fixed_checksums_identical`` is
asserted there (it raises otherwise); at more ranks it is reported only.  Ranks
that share a card (gloo on one card) measure the collectives' overhead, not
scaling.

Usage::

    python scripts/scaling_multiproc_torch.py                  # the card(s)
    python scripts/scaling_multiproc_torch.py --device cpu --ranks 1,2 \\
        --envs 64 --steps 16 --reps 3
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
LAUNCHER = os.path.join(ROOT, "scripts", "launch_multihost_torch.py")
EXACT_RANKS = 2   # a sum of at most this many terms is exact in any order


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--ranks", default="1,2",
                   help="comma-separated rank counts of the fixed-work rows")
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--reps", type=int, default=5)
    return p.parse_args(argv)


def run_point(device, backend, ranks, envs, steps, reps) -> dict:
    """One launcher run (``--spawn ranks``): rank 0's JSON line."""
    spec = importlib.util.spec_from_file_location("launch_multihost_torch", LAUNCHER)
    launcher = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(launcher)
    return launcher.run_spawned(launcher.parse_args([
        "--spawn", str(ranks), "--device", device, "--backend", backend,
        "--num-envs", str(envs), "--steps", str(steps), "--reps", str(reps)]))


def run(args) -> dict:
    """Every point, the table's rows and the JSON summary (returned and
    printed last)."""
    import torch

    from gym_collision_avoidance_torch.core.device import card_label, resolve_device

    resolve_device(args.device)
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    rank_counts = [int(x) for x in args.ranks.split(",")]
    weak_backend = "nccl" if cards >= 2 else "gloo"
    points = {}

    def point(backend, ranks, envs):
        key = (backend, ranks, envs)
        if key not in points:
            points[key] = run_point(args.device, backend, ranks, envs, args.steps, args.reps)
        return points[key]

    rows = []
    for ranks in rank_counts:
        for backend in ("gloo", "nccl"):
            if backend == "nccl" and ranks > cards:
                continue
            rows.append(("fixed", ranks, backend, args.envs, point(backend, ranks, args.envs)))
    for ranks in (1, 2):
        envs = args.envs * ranks
        rows.append(("weak", ranks, weak_backend, envs, point(weak_backend, ranks, envs)))

    base = rows[0][4]["agent_steps_per_s"]
    weak1 = next(r for kind, n, _b, _e, r in rows if (kind, n) == ("weak", 1))
    print("| regime | ranks x transport | envs | agent-steps/s | spread | efficiency |")
    print("|---|---|---|---|---|---|")
    out = {}
    for kind, ranks, backend, envs, r in rows:
        if kind == "fixed":
            eff = r["agent_steps_per_s"] / base
        else:   # ideal: the 1-rank rate times the rank count
            eff = r["agent_steps_per_s"] / (weak1["agent_steps_per_s"] * ranks)
        print(f"| {kind} | {ranks} x {backend} | {envs} | {r['agent_steps_per_s']:.3e} | "
              f"{r['spread_min']:.2e}..{r['spread_max']:.2e} | {eff:.1%} |")
        out[f"{kind}_{ranks}x{backend}"] = {
            "agent_steps_per_s": r["agent_steps_per_s"], "efficiency": eff,
            "checksum": r["metrics_checksum"], "launches_by_rank": r["launches_by_rank"]}
    sums = {n: {r["metrics_checksum"] for kind, m, _b, _e, r in rows if (kind, m) == ("fixed", n)}
            for n in rank_counts}
    out["fixed_checksums_identical"] = all(len(s) == 1 for s in sums.values())
    out["fixed_checksums_by_ranks"] = {str(n): sorted(s) for n, s in sums.items()}
    out["device"] = card_label(args.device)
    out["shared_cards"] = args.device == "cuda" and max(rank_counts + [2]) > cards
    if out["shared_cards"]:
        out["note"] = "ranks share a card over gloo: the collectives' overhead, not scaling"
    print(json.dumps(out), flush=True)
    exact = [n for n in rank_counts if n <= EXACT_RANKS]
    if any(len(sums[n]) != 1 for n in exact):
        raise RuntimeError(f"the reduced metrics' checksum depends on the transport at "
                           f"{exact} ranks: {out['fixed_checksums_by_ranks']}")
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
