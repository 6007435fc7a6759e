#!/usr/bin/env python3
"""Multi-process launcher for the PyTorch port's distributed env batch.

The counterpart of ``scripts/launch_multihost.py``: one process per card
(or per host), joined in one ``torch.distributed`` process group with a
global ``("env",)`` mesh (``gym_collision_avoidance_torch/parallel``); each
rank builds and steps only its slice of the env batch, and the per-step
metrics are reduced over the ranks once a dispatch.

Real fleet (one line per process, each with a card of its own; NCCL)::

    python scripts/launch_multihost_torch.py --coordinator host0:7733 \\
        --num-processes 4 --process-id $I --num-envs 16384 --steps 256

or under ``torchrun --nproc-per-node 4 scripts/launch_multihost_torch.py``.

Local demonstration (N ranks on this machine, gloo, CPU)::

    python scripts/launch_multihost_torch.py --spawn 2 --device cpu \\
        --num-envs 64 --steps 32

``--device`` is ``cuda`` unless given, and then raises without a card;
the backend follows from it (``nccl`` for ``cuda``, one card a rank, and
``gloo`` for ``cpu``) unless ``--backend`` names one: ``--backend gloo`` on
``cuda`` lets ranks share a card, and ``--spawn N`` over NCCL with fewer
than N cards raises.  Each rep starts after a barrier that drains every
rank's device and lasts until the slowest rank's device holds the reduced
metrics.  Process 0 prints one JSON line with the throughput, the checksum
of the reduced metrics (the same on every rank by construction) and each
rank's kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--init-method", default=None,
                   help="rendezvous URL (e.g. file:///tmp/x); --spawn sets it for its ranks")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--num-agents", type=int, default=4)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--spawn", type=int, default=None,
                   help="start N local ranks of this script (one intra-op thread each)")
    p.add_argument("--reps", type=int, default=1,
                   help="timed repetitions after a warm-up; reports the median")
    return p.parse_args(argv)


def run_spawned(args) -> dict:
    """Parent mode: run this script as ``--spawn`` local ranks and return
    rank 0's JSON line; raises ``RankFailed`` (with the ranks' stderr) if a
    rank fails."""
    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.parallel import distributed as dist

    resolve_device(args.device)
    backend = dist.choose_backend(args.device, args.spawn, args.backend)
    if args.device == "cuda":
        from gym_collision_avoidance_torch.ops import build

        build.build(["pairwise"])
    rank_args = ["--device", args.device, "--backend", backend,
                 "--num-envs", str(args.num_envs), "--num-agents", str(args.num_agents),
                 "--steps", str(args.steps), "--reps", str(args.reps)]
    ranks = dist.spawn_local([sys.executable, os.path.abspath(__file__), *rank_args],
                             args.spawn, threads=None if args.device == "cuda" else 1,
                             capture=True)
    return json.loads(next(line for line in ranks[0].stdout.splitlines()
                           if line.startswith("{")))


def spawn(args) -> int:
    """``--spawn``: print :func:`run_spawned`'s line, or the failure."""
    from gym_collision_avoidance_torch.parallel import distributed as dist

    try:
        print(json.dumps(run_spawned(args)), flush=True)
    except dist.RankFailed as err:
        print(err, file=sys.stderr)
        return 1
    return 0


def run_worker(args) -> None:
    import torch
    import torch.distributed

    from gym_collision_avoidance_torch import EnvConfig, ops
    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.env.step import env_reset
    from gym_collision_avoidance_torch.parallel import distributed as dist
    from gym_collision_avoidance_torch.scenarios import presets

    resolve_device(args.device)
    backend = args.backend or {"cuda": "nccl", "cpu": "gloo"}[args.device]
    dist.init_distributed(backend, coordinator_address=args.coordinator,
                          num_processes=args.num_processes, process_id=args.process_id,
                          init_method=args.init_method)
    mesh = dist.global_mesh(args.device)

    cfg = EnvConfig.evaluate(dtype="float32")
    sc = presets.circle_scenario(args.num_agents, radius=4.0, agent_radius=0.4)
    base, _ = env_reset(sc.to_state(cfg, device=mesh.device), cfg)

    def build(indices):
        return base.map(lambda x: x.repeat((len(indices),) + (1,) * (x.dim() - 1)))

    run = dist.make_distributed_rollout(cfg, args.steps, mesh,
                                        active_policies=sc.active_policies)
    ops.zero_launch_counts()
    _, metrics = run(dist.host_local_batch(build, args.num_envs, mesh))   # warm-up
    elapsed = []
    for _ in range(max(args.reps, 1)):
        states = dist.host_local_batch(build, args.num_envs, mesh)
        # the slowest rank's window, until its device has the reduced metrics
        seconds, metrics = dist.timed_over_ranks(mesh, lambda: run(states)[1])
        elapsed.append(seconds)
    checksum = float(metrics["mean_reward"].sum())
    counts = {k: dist.gather_scalars(mesh, n) for k, n in ops.launch_counts().items()}
    launches = [{k: int(v[r]) for k, v in counts.items()} for r in range(mesh.size)]
    env_steps = args.num_envs * args.num_agents * args.steps
    rates = sorted(env_steps / e for e in elapsed)
    if mesh.rank == 0:
        print(json.dumps({
            "num_processes": mesh.size, "backend": mesh.backend, "device": str(mesh.device),
            "num_envs": args.num_envs, "steps": args.steps,
            "agent_steps_per_s": rates[len(rates) // 2], "spread_min": rates[0],
            "spread_max": rates[-1], "metrics_checksum": checksum,
            "done_count": float(metrics["done_count"].sum()),
            "launches_by_rank": launches,
        }), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.spawn:
        return spawn(args)
    run_worker(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
