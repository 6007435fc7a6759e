#!/usr/bin/env python3
"""Scaling of the PyTorch port's env batch over ranks (the counterpart of
``scripts/scaling_bench.py``).

Five tables over rank counts 1, 2, 4, 8, ... up to ``--max-ranks``, each
rank count one job of ranks started by ``parallel.distributed.spawn_local``,
one process and one device a rank:

* the weak-scaling rollout (``make_distributed_rollout``): ``--envs-per-device``
  envs a rank x ``--num-agents`` agents, ``--steps`` steps;
* the fixed-work rollout: the largest rank count's env batch on every count;
* the sharded serving loop (``AutoresetServer(mesh=)``), weak and fixed: a
  16-case pool, NonCoop agents, 4 dispatches of ``--steps`` steps a rep;
* DP-PPO at fixed work: T = 16, 2 epochs x 2 minibatches, ``make_ppo`` on one
  rank and ``make_sharded_ppo`` on more.

A rep starts after a barrier that also drains each rank's device and ends
with each rank's device synchronised; its time is the slowest rank's, taken
with one ``all_reduce(MAX)``-equivalent after the window.  The best of
``--reps`` counts.  Each rank's kernel launches are counted in every table.

The backend is NCCL on the card (one card a rank: more ranks than visible
cards raise) and gloo on the CPU; ``--backend gloo`` on the card lets ranks
share cards.  Gloo copies CUDA tensors through the host, so ranks that
share a card measure the collectives' overhead, not scaling; the markdown
says so beside the numbers.

Usage::

    python scripts/scaling_bench_torch.py                       # NCCL, every card
    python scripts/scaling_bench_torch.py --backend gloo --max-ranks 2
    python scripts/scaling_bench_torch.py --device cpu --max-ranks 2 \\
        --envs-per-device 8 --steps 8 --out results/scaling_torch_cpu.md

``--out`` (default ``results/scaling_torch.md``; ``-`` writes nothing) gets
the markdown tables.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PPO_HORIZON = 16
SERVE_DISPATCHES = 4
OVERHEAD_NOTE = ("ranks share a card: gloo copies every collective's CUDA tensors through "
                 "the host, so these numbers are the collectives' overhead, not scaling")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda (one card a rank), gloo on cpu")
    p.add_argument("--max-ranks", type=int, default=None,
                   help="largest rank count (default: the visible cards on cuda, 2 on cpu)")
    p.add_argument("--envs-per-device", type=int, default=32)
    p.add_argument("--num-agents", type=int, default=4)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=os.path.join("results", "scaling_torch.md"),
                   help="markdown file to write ('-': none)")
    p.add_argument("--fixed-envs", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank-job", action="store_true", help=argparse.SUPPRESS)
    from gym_collision_avoidance_torch.parallel import distributed

    distributed.add_rank_flags(p)
    return p.parse_args(argv)


# ------------------------------------------------------------------ a rank


def rank_tables(args, mesh) -> dict:
    """This rank's share of every table at ``mesh.size`` ranks: the best
    rep's seconds (the slowest rank's), episodes, and kernel launches."""
    import numpy as np
    import torch

    from gym_collision_avoidance_torch import EnvConfig, ops
    from gym_collision_avoidance_torch.entry import repeat_envs
    from gym_collision_avoidance_torch.env.step import env_reset
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer
    from gym_collision_avoidance_torch.parallel import distributed as dist
    from gym_collision_avoidance_torch.scenarios import presets, random_cases
    from gym_collision_avoidance_torch.train import PPOConfig, make_ppo, make_sharded_ppo

    D, A, S = mesh.size, args.num_agents, args.steps
    E_weak, E_fixed = args.envs_per_device * D, args.fixed_envs
    out = {}

    def table(name, fn):
        ops.zero_launch_counts()
        out[name] = fn()
        out[name]["launches"] = ops.launch_counts()

    cfg = EnvConfig.evaluate(dtype="float32")
    sc = presets.circle_scenario(A, radius=4.0, agent_radius=0.4)
    base, _ = env_reset(sc.to_state(cfg, device=mesh.device), cfg)

    def rollout(E):
        run = dist.make_distributed_rollout(cfg, S, mesh, active_policies=sc.active_policies)
        best = float("inf")
        for _ in range(args.reps):
            states = dist.host_local_batch(lambda idx: repeat_envs(base, len(idx)), E, mesh)
            best = min(best, dist.timed_over_ranks(mesh, lambda: run(states))[0])
        return {"envs": E, "seconds": best}

    table("rollout_weak", lambda: rollout(E_weak))
    table("rollout_fixed", lambda: rollout(E_fixed))

    scfg = EnvConfig(dtype="float32", done_mode="evaluate")
    pool = random_cases.scenario_pool(16, A, seed=0, side_length=4.0)
    pid = np.full(A, 1, np.int32)    # NonCoop

    def serving(E):
        server = AutoresetServer(scfg, pool, pid, num_envs=E, steps_per_dispatch=S, mesh=mesh)
        server.dispatch()             # warm-up
        best = float("inf")
        for _ in range(args.reps):
            best = min(best, dist.timed_over_ranks(
                mesh, lambda: [server.dispatch() for _ in range(SERVE_DISPATCHES)])[0])
        return {"envs": E, "seconds": best, "episodes": server.episodes_completed()}

    table("serving_weak", lambda: serving(E_weak))
    table("serving_fixed", lambda: serving(E_fixed))

    def ppo():
        ppo_g = PPOConfig(num_envs=E_fixed, horizon=PPO_HORIZON, num_agents=A, epochs=2,
                          num_minibatches=2)
        if D == 1:
            step, init_fn, _ = make_ppo(ppo_g, device=mesh.device)
        else:
            step, init_fn, _ = make_sharded_ppo(ppo_g, mesh)
        carry = init_fn(0)

        def one_step():
            nonlocal carry
            *carry, _m = step(*carry, rng=torch.Generator(mesh.device).manual_seed(1))

        one_step()                    # warm-up
        best = float("inf")
        for _ in range(args.reps):
            best = min(best, dist.timed_over_ranks(mesh, one_step)[0])
        return {"envs": E_fixed, "seconds": best}

    table("ppo", ppo)
    return out


def rank_main(args) -> int:
    from gym_collision_avoidance_torch.parallel import distributed as dist

    mesh = dist.join_rank_job(args, args.backend, args.device)
    dist.save_rank_result(args, mesh, {"rank": mesh.rank, "device": str(mesh.device),
                                       "backend": mesh.backend,
                                       "tables": rank_tables(args, mesh)})
    return 0


# ---------------------------------------------------------------- the parent


def rank_counts(max_ranks: int):
    return [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= max_ranks]


def platform_line(device: str, backend: str, max_ranks: int, cards: int) -> str:
    """Backend, ranks and device; on the card its ``nvidia-smi`` name and
    power limit and how many ranks share each card."""
    from gym_collision_avoidance_torch.core.device import card_label

    if device == "cpu":
        return (f"{backend}, up to {max_ranks} ranks on the CPU ({os.cpu_count()} cores, "
                "1 intra-op thread a rank)")
    used = min(cards, max_ranks)
    return (f"{backend}, up to {max_ranks} ranks on {used} card(s) ({card_label('cuda:0')}), "
            f"up to {-(-max_ranks // used)} rank(s) a card")


def run(args) -> dict:
    """Every table (rows as the JAX script's, with ``ranks`` for its
    ``devices``), the platform line and each rank count's launches by rank."""
    import torch

    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.parallel import distributed as dist

    resolve_device(args.device)
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    max_ranks = args.max_ranks or cards or 2
    backend = dist.choose_backend(args.device, max_ranks, args.backend)
    if args.device == "cuda":
        from gym_collision_avoidance_torch.ops import build

        build.build(["pairwise"])
    sizes = rank_counts(max_ranks)
    E_fixed = args.envs_per_device * sizes[-1]
    A, S = args.num_agents, args.steps
    command = [sys.executable, os.path.abspath(__file__), "--rank-job", "--device", args.device,
               "--backend", backend, "--envs-per-device", str(args.envs_per_device),
               "--num-agents", str(A), "--steps", str(S), "--reps", str(args.reps),
               "--fixed-envs", str(E_fixed)]
    tables = {k: [] for k in ("rollout_weak", "rollout_fixed", "serving_weak",
                              "serving_fixed", "ppo")}
    launches = {}
    for n in sizes:
        ranks = dist.run_rank_job(command, n, threads=None if args.device == "cuda" else 1,
                                  timeout=1800)
        launches[n] = [{k: t["launches"] for k, t in r["tables"].items()} for r in ranks]
        got = ranks[0]["tables"]   # every rank holds the slowest rank's seconds
        for name in ("rollout_weak", "rollout_fixed"):
            t = got[name]
            rate = t["envs"] * A * S / t["seconds"]
            row = {"ranks": n, "envs": t["envs"], "agent_steps_per_s": rate}
            if name == "rollout_weak":
                row["per_device"] = rate / n
            tables[name].append(row)
        for name in ("serving_weak", "serving_fixed"):
            t = got[name]
            tables[name].append({"ranks": n, "envs": t["envs"],
                                 "env_steps_per_s": SERVE_DISPATCHES * t["envs"] * S
                                 / t["seconds"], "episodes": t["episodes"]})
        t = got["ppo"]
        tables["ppo"].append({"ranks": n, "envs": t["envs"],
                              "train_env_steps_per_s": t["envs"] * PPO_HORIZON / t["seconds"]})
    for name, key in (("rollout_weak", "agent_steps_per_s"),
                      ("rollout_fixed", "agent_steps_per_s"),
                      ("serving_weak", "env_steps_per_s"), ("serving_fixed", "env_steps_per_s"),
                      ("ppo", "train_env_steps_per_s")):
        first = tables[name][0]
        for row in tables[name]:
            row["vs_1dev"] = row[key] / first[key]
            if name.endswith("_weak"):
                row["efficiency"] = row["vs_1dev"] / row["ranks"]
            print(json.dumps({"table": name, **row}), flush=True)
    result = {"platform": platform_line(args.device, backend, max_ranks, cards),
              "backend": backend,
              "device": args.device, "envs_per_device": args.envs_per_device,
              "num_agents": A, "steps": S, "reps": args.reps, "fixed_envs": E_fixed,
              "ppo_horizon": PPO_HORIZON, "tables": tables, "launches_by_rank": launches,
              "shared_cards": args.device == "cuda" and max_ranks > cards}
    if args.out and args.out != "-":
        write_markdown(args.out, result)
        print(f"wrote {args.out}", flush=True)
    return result


def write_markdown(path: str, r: dict) -> None:
    """The JAX script's markdown sections, from :func:`run`'s result."""
    t = r["tables"]
    note = [f"**{OVERHEAD_NOTE}.**", ""] if r["shared_cards"] else []
    lines = [
        "# Weak-scaling measurement (PyTorch port, torch.distributed ranks)",
        "",
        f"Config: {r['envs_per_device']} envs/rank x {r['num_agents']} agents, "
        f"{r['steps']}-step rollout, best of {r['reps']} reps "
        "(scripts/scaling_bench_torch.py).",
        f"Platform: {r['platform']}.",
        "",
        *note,
        "| ranks | envs | agent-steps/s | per-rank | efficiency |",
        "|---:|---:|---:|---:|---:|",
    ]
    lines += [f"| {x['ranks']} | {x['envs']} | {x['agent_steps_per_s']:.3e} | "
              f"{x['per_device']:.3e} | {x['efficiency']:.2f} |" for x in t["rollout_weak"]]
    lines += ["", "## Sharding overhead (fixed total work)", "",
              f"The same {r['fixed_envs']}-env batch over growing rank counts.", "",
              "| ranks | envs | agent-steps/s | vs 1 rank |", "|---:|---:|---:|---:|"]
    lines += [f"| {x['ranks']} | {x['envs']} | {x['agent_steps_per_s']:.3e} | "
              f"{x['vs_1dev']:.2f} |" for x in t["rollout_fixed"]]
    lines += ["", "## Sharded serving loop (AutoresetServer, weak + fixed work)", "",
              f"{SERVE_DISPATCHES} dispatches of {r['steps']} steps a rep.", "",
              "| ranks | envs | env-steps/s | vs 1 rank | weak eff | episodes |",
              "|---:|---:|---:|---:|---:|---:|"]
    lines += [f"| {x['ranks']} | {x['envs']} | {x['env_steps_per_s']:.3e} | "
              f"{x['vs_1dev']:.2f} | {x['efficiency']:.2f} | {x['episodes']} |"
              for x in t["serving_weak"]]
    lines += ["", "fixed total work (same batch, growing rank count):", "",
              "| ranks | envs | env-steps/s | vs 1 rank | episodes |",
              "|---:|---:|---:|---:|---:|"]
    lines += [f"| {x['ranks']} | {x['envs']} | {x['env_steps_per_s']:.3e} | "
              f"{x['vs_1dev']:.2f} | {x['episodes']} |" for x in t["serving_fixed"]]
    lines += ["", "## DP-PPO training step (fixed total work)", "",
              f"The full PPO iteration (rollout T={r['ppo_horizon']} + GAE + 2 epochs x 2 "
              f"minibatches) on the {r['fixed_envs']}-env batch: make_ppo on 1 rank, "
              "make_sharded_ppo (gradients averaged a minibatch) on more.", "",
              "| ranks | envs | train env-steps/s | vs 1 rank |", "|---:|---:|---:|---:|"]
    lines += [f"| {x['ranks']} | {x['envs']} | {x['train_env_steps_per_s']:.3e} | "
              f"{x['vs_1dev']:.2f} |" for x in t["ppo"]]
    lines.append("")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank_job:
        return rank_main(args)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
