#!/usr/bin/env python3
"""What the PyTorch port's collectives cost over its ranks (the counterpart of
``scripts/collective_overhead.py``), in four parts:

1. **Traffic, from the port's own call sites**: the PPO trainer all-reduces
   ``[sum w, sum a w]`` (2 floats, ``train/ppo.py:gradients``), ``sum w d^2``
   (1 float) and the flattened gradients (``EnvMesh.pmean_flat``) once a
   minibatch, and the 4 stacked metrics once an iteration; the server one
   stacked ``[S, 1 + A]`` buffer a dispatch (``harness/serving.py:_reduce``;
   ``episodes_completed`` one ``[1]`` int64 a call); the rollout one ``[2,
   S]`` buffer a dispatch (``parallel/distributed.py:make_distributed_rollout``).
   The port stacks scalars that the JAX trainer reduces one by one, so its
   count is its own (the JAX script's ``n_mb * 3 + 5`` is printed beside
   it).  The ranks record every ``torch.distributed.all_reduce`` of one
   sharded iteration, and the script raises if the record and the
   accounting differ.
2. **The cost of one all-reduce**: ``--calls`` back-to-back all-reduces of a
   gradient-sized float32 buffer and of a 1-element one, each against the
   same loop with the all-reduce left out; (chain - identity) / calls.
3. **The PPO step with and without its collectives**: ``make_sharded_ppo`` on
   the ranks' mesh, and on a timing-only mesh whose ``psum`` is the identity
   while its size stays D (so every mean still divides by D; it trains
   incorrectly, as the JAX script's ``axis_name=None`` variant does), both
   with the same host reads; then the attribution check against part 2.
4. **A projection, from the card's own numbers**: a ring all-reduce's
   latency term (2 (D - 1) hops, the hop from part 2's 1-element cost) and
   bandwidth term (2 G (D - 1) / D over the link rate), against 1-rank step
   times measured in the same run.  The link rate is the H100 SXM's NVLink,
   a published figure not measured here.

Every rep starts after a barrier that drains each rank's device, and its
time is the slowest rank's.  The backend is NCCL on the card (one card a
rank; more ranks than cards raise) and gloo on the CPU; ``--backend gloo``
lets ranks share a card, where gloo's all-reduce copies through the host:
its cost is then host staging, not NVLink, and the numbers are overhead,
not scaling.

Usage::

    python scripts/collective_overhead_torch.py                # NCCL, every card
    python scripts/collective_overhead_torch.py --backend gloo --ranks 2
    python scripts/collective_overhead_torch.py --device cpu --ranks 2 --ppo-envs 16 \\
        --calls 16 --append results/collectives_torch.md
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

F32 = 4
# NVIDIA H100 SXM data sheet: NVLink 900 GB/s a GPU, both directions
# together; a ring sends one way, so 450 GB/s.  Published, not measured here.
NVLINK_BYTES_PER_S = 450e9
NVLINK_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, SXM: NVLink 900 GB/s a GPU "
                 "(both directions), 450 GB/s one way; published, not measured here")
PROJECT_RANKS = (2, 4, 8)      # one HGX H100 node's NVLink domain


def ppo_config(args):
    from gym_collision_avoidance_torch.train import PPOConfig

    return PPOConfig(num_envs=args.ppo_envs, horizon=16, num_agents=args.num_agents,
                     epochs=2, num_minibatches=2)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda (one card a rank), gloo on cpu")
    p.add_argument("--ranks", type=int, default=None,
                   help="rank count (default: the visible cards on cuda, 2 on cpu)")
    p.add_argument("--envs", type=int, default=8192,
                   help="env count of the serving and rollout accounting and of the 1-rank "
                        "serving step")
    p.add_argument("--steps", type=int, default=128, help="steps a serving dispatch")
    p.add_argument("--num-agents", type=int, default=4)
    p.add_argument("--ppo-envs", type=int, default=256,
                   help="global env count of the measured PPO step")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--calls", type=int, default=256,
                   help="back-to-back all-reduces a timed chain")
    p.add_argument("--append", default=None,
                   help="append the markdown section to this file (default: none)")
    p.add_argument("--rank-job", action="store_true", help=argparse.SUPPRESS)
    from gym_collision_avoidance_torch.parallel import distributed

    distributed.add_rank_flags(p)
    return p.parse_args(argv)


# ------------------------------------------------------------- 1. traffic


def traffic(ppo, num_agents: int, steps: int, envs: int) -> dict:
    """Part 1: all-reduces and bytes of each program, from its call sites
    (float32 buffers; the parameters of ``ppo``'s net, drawn on the CPU)."""
    from gym_collision_avoidance_torch.train import make_ppo
    from gym_collision_avoidance_torch.train.ppo import trainable_params

    _step, init_fn, _ = make_ppo(ppo, device="cpu")
    params = trainable_params(init_fn(0)[0])
    grad_bytes = sum(p.numel() * p.element_size() for p in params.values())
    n_mb = ppo.epochs * ppo.num_minibatches
    serve_bytes = F32 * steps * (1 + num_agents)
    return {
        "grad_bytes": grad_bytes,
        "param_count": sum(p.numel() for p in params.values()),
        "minibatches_per_train_step": n_mb,
        # per minibatch: [sum w, sum a w], sum w d^2, the gradients; once: 4 metrics
        "all_reduces_per_train_step": 3 * n_mb + 1,
        "bytes_per_train_step": n_mb * (2 * F32 + F32 + grad_bytes) + 4 * F32,
        "jax_scalar_pmeans_per_train_step": 3 * n_mb + 5,
        "rollout_all_reduces_per_dispatch": 1,
        "rollout_bytes_per_step": 2 * F32,
        "rollout_bytes_per_env_step": 2 * F32 / envs,
        "serving_all_reduces_per_dispatch": 1,
        "serving_bytes_per_dispatch": serve_bytes,
        "serving_bytes_per_step": serve_bytes / steps,
        "serving_bytes_per_env_step": serve_bytes / steps / envs,
        "episodes_completed_bytes_per_call": 8,
    }


class AllReduceRecord:
    """Every ``torch.distributed.all_reduce`` made inside ``with record:``
    (calls and bytes), the original called through."""

    def __init__(self):
        self.calls = self.bytes = 0

    def __enter__(self):
        import torch.distributed as tdist

        self._orig = tdist.all_reduce

        def counted(tensor, *a, **k):
            self.calls += 1
            self.bytes += tensor.numel() * tensor.element_size()
            return self._orig(tensor, *a, **k)

        tdist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist

        tdist.all_reduce = self._orig


# ----------------------------------------------------------------- a rank


def timing_only_mesh(mesh):
    """Part 3's mesh: ``mesh``'s ranks, device, group and size, with a
    ``psum`` that returns its input, so a mean still divides by the rank
    count.  Timing only: the ranks train apart."""
    from gym_collision_avoidance_torch.parallel.mesh import EnvMesh

    class TimingOnlyMesh(EnvMesh):
        def psum(self, tensor):
            return tensor

    return TimingOnlyMesh(mesh.device, mesh.group)


def rank_parts(args, mesh) -> dict:
    """Parts 2 and 3 on every rank, then rank 0's 1-rank step times."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from gym_collision_avoidance_torch import EnvConfig, ops
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer
    from gym_collision_avoidance_torch.parallel import distributed as dist
    from gym_collision_avoidance_torch.parallel.mesh import EnvMesh
    from gym_collision_avoidance_torch.scenarios import random_cases
    from gym_collision_avoidance_torch.train import make_ppo, make_sharded_ppo

    K, ppo = args.calls, ppo_config(args)
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend}

    def best(fn, ranks=mesh, warm=True):
        """The best of ``--reps`` windows of ``fn`` (the slowest rank's)."""
        if warm:
            fn()
        return min(dist.timed_over_ranks(ranks, fn)[0] for _ in range(args.reps))

    def ppo_stepper(step, init_fn):
        carry = init_fn(0)

        def one_step():
            nonlocal carry
            *carry, _m = step(*carry, rng=torch.Generator(mesh.device).manual_seed(1))

        return one_step

    # 2. the cost of one all-reduce: a chain of K against the identity chain
    numel = traffic(ppo, args.num_agents, args.steps, args.envs)["param_count"]
    out["chains"] = []
    for label, n in (("gradient-sized buffer", numel), ("one float32", 1)):
        x = torch.ones(n, dtype=torch.float32, device=mesh.device)

        def chain(collective):
            def run():
                for _ in range(K):
                    x.mul_(1.000001)        # the value changes, so no call repeats another
                    if collective:
                        tdist.all_reduce(x, group=mesh.group)
            return run

        t_with, t_base = best(chain(True)), best(chain(False))
        out["chains"].append({"payload": label, "bytes": n * F32,
                              "per_all_reduce_us": (t_with - t_base) / K * 1e6,
                              "chain_with_s": t_with, "chain_base_s": t_base})

    # 3. the sharded PPO step with its collectives, and with psum the identity
    out["ppo"] = []
    for label, m in (("with all-reduces", mesh),
                     ("all-reduces left out (timing-only)", timing_only_mesh(mesh))):
        one_step = ppo_stepper(*make_sharded_ppo(ppo, m)[:2])
        ops.zero_launch_counts()
        with AllReduceRecord() as record:
            one_step()                      # the warm-up, recorded
        launches = ops.launch_counts()
        out["ppo"].append({"variant": label, "train_step_s": best(one_step, warm=False),
                           "recorded_all_reduces": record.calls,
                           "recorded_bytes": record.bytes, "warm_up_launches": launches})

    # the 1-rank step times of the projection: rank 0 alone, the others wait
    dist.sync_ranks(mesh)
    if mesh.rank == 0:
        alone = EnvMesh(mesh.device)
        pool = random_cases.scenario_pool(16, args.num_agents, seed=0, side_length=4.0)
        server = AutoresetServer(EnvConfig(dtype="float32", done_mode="evaluate"), pool,
                                 np.full(args.num_agents, 1, np.int32), num_envs=args.envs,
                                 steps_per_dispatch=args.steps, device=mesh.device)
        out["one_rank"] = {
            "ppo_step_s": best(ppo_stepper(*make_ppo(ppo, device=mesh.device)[:2]), alone),
            "serving_step_s": best(server.dispatch, alone) / args.steps}
    dist.sync_ranks(mesh)
    return out


def rank_main(args) -> int:
    from gym_collision_avoidance_torch.parallel import distributed as dist

    mesh = dist.join_rank_job(args, args.backend, args.device)
    dist.save_rank_result(args, mesh, rank_parts(args, mesh))
    return 0


# ---------------------------------------------------------------- the parent


def ring_all_reduce_s(nbytes: float, d: int, hop_s: float) -> float:
    """A ring all-reduce of ``nbytes`` over ``d`` ranks: 2 (d - 1) hops of
    latency, and reduce-scatter plus all-gather, each (d - 1) / d of the
    bytes over one link one way."""
    return 2 * (d - 1) * hop_s + 2 * nbytes * (d - 1) / d / NVLINK_BYTES_PER_S


def projection(tr: dict, ranks: int, per_scalar_us: float, one_rank: dict,
               steps: int) -> list:
    """Part 4: the predicted overhead and efficiency at each of
    ``PROJECT_RANKS`` ranks over NVLink, the hop latency taken from this
    run's 1-element all-reduce on ``ranks`` ranks."""
    hop_s = max(per_scalar_us, 0.0) * 1e-6 / max(2 * (ranks - 1), 1)
    n_mb = tr["minibatches_per_train_step"]
    rows = []
    for d in PROJECT_RANKS:
        grad_s = ring_all_reduce_s(tr["grad_bytes"], d, hop_s)
        train_ovh = n_mb * (grad_s + ring_all_reduce_s(2 * F32, d, hop_s)
                            + ring_all_reduce_s(F32, d, hop_s)) \
            + ring_all_reduce_s(4 * F32, d, hop_s)
        serve_ovh = ring_all_reduce_s(tr["serving_bytes_per_dispatch"], d, hop_s) / steps
        rows.append({
            "ranks": d, "hop_us": hop_s * 1e6, "grad_all_reduce_us": grad_s * 1e6,
            "ppo_overhead_us": train_ovh * 1e6,
            "ppo_projected_efficiency": one_rank["ppo_step_s"]
            / (one_rank["ppo_step_s"] + train_ovh),
            "serving_projected_efficiency": one_rank["serving_step_s"]
            / (one_rank["serving_step_s"] + serve_ovh)})
    return rows


def run(args) -> dict:
    """All four parts; prints each part's JSON lines and returns them."""
    import torch

    from gym_collision_avoidance_torch.core.device import card_label, resolve_device
    from gym_collision_avoidance_torch.parallel import distributed as dist

    resolve_device(args.device)
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    ranks = args.ranks or cards or 2
    backend = dist.choose_backend(args.device, ranks, args.backend)
    if args.device == "cuda":
        from gym_collision_avoidance_torch.ops import build

        build.build(["pairwise"])
    ppo = ppo_config(args)
    tr = traffic(ppo, args.num_agents, args.steps, args.envs)
    print(json.dumps({"traffic": tr}), flush=True)

    command = [sys.executable, os.path.abspath(__file__), "--rank-job", "--device", args.device,
               "--backend", backend, "--envs", str(args.envs), "--steps", str(args.steps),
               "--num-agents", str(args.num_agents), "--ppo-envs", str(args.ppo_envs),
               "--reps", str(args.reps), "--calls", str(args.calls)]
    results = dist.run_rank_job(command, ranks, threads=None if args.device == "cuda" else 1,
                                timeout=1800)
    first = results[0]
    recorded = {"all_reduces_per_train_step": first["ppo"][0]["recorded_all_reduces"],
                "bytes_per_train_step": first["ppo"][0]["recorded_bytes"]}
    for r in results:
        got = (r["ppo"][0]["recorded_all_reduces"], r["ppo"][0]["recorded_bytes"])
        if got != (tr["all_reduces_per_train_step"], tr["bytes_per_train_step"]):
            raise RuntimeError(f"rank {r['rank']} recorded {got} all-reduces and bytes in one "
                               f"train step; the accounting says "
                               f"{tr['all_reduces_per_train_step']}, "
                               f"{tr['bytes_per_train_step']}")
        if r["ppo"][1]["recorded_all_reduces"]:
            raise RuntimeError("the timing-only mesh made an all-reduce")
    for row in first["chains"]:
        print(json.dumps(row), flush=True)
    for row in first["ppo"]:
        print(json.dumps({k: row[k] for k in ("variant", "train_step_s")}), flush=True)
    overhead_s = first["ppo"][0]["train_step_s"] - first["ppo"][1]["train_step_s"]
    n_mb = tr["minibatches_per_train_step"]
    per_grad_us, per_scalar_us = (c["per_all_reduce_us"] for c in first["chains"])
    n_small = tr["all_reduces_per_train_step"] - n_mb
    predicted_us = n_mb * per_grad_us + n_small * per_scalar_us
    print(f"measured collective overhead: {overhead_s * 1e3:.3f} ms a train step ({n_mb} "
          f"gradient + {n_small} small all-reduces; the chains predict "
          f"{predicted_us / 1e3:.3f} ms)", flush=True)
    proj = projection(tr, ranks, per_scalar_us, first["one_rank"], args.steps)
    for row in proj:
        print(json.dumps(row), flush=True)
    result = {"device": card_label(args.device), "backend": backend, "ranks": ranks,
              "shared_cards": args.device == "cuda" and ranks > cards,
              "traffic": tr, "recorded": recorded, "chains": first["chains"],
              "ppo": first["ppo"], "overhead_s": overhead_s,
              "predicted_overhead_s": predicted_us * 1e-6, "one_rank": first["one_rank"],
              "projection": proj, "link": NVLINK_SOURCE, "calls": args.calls,
              "reps": args.reps, "ppo_envs": args.ppo_envs, "envs": args.envs,
              "steps": args.steps}
    if args.append:
        append_markdown(args.append, result)
        print(f"appended to {args.append}", flush=True)
    return result


def append_markdown(path: str, r: dict) -> None:
    tr = r["traffic"]
    n_mb = tr["minibatches_per_train_step"]
    where = (f"{r['ranks']} {r['backend']} ranks on {r['device']}")
    lines = ["", "## Measured collective overhead (scripts/collective_overhead_torch.py)", "",
             f"Ranks: {where}."]
    if r["shared_cards"]:
        lines += ["", "**The ranks share a card: gloo copies each all-reduce through the "
                  "host, so these costs are host staging, not NVLink: overhead, not "
                  "scaling.**"]
    lines += ["", "Collective traffic, from the port's call sites (recorded in one sharded "
              f"iteration: {r['recorded']['all_reduces_per_train_step']} all-reduces, "
              f"{r['recorded']['bytes_per_train_step']} B):", "",
              "| program | all-reduces | bytes |", "|---|---|---:|",
              f"| rollout (make_distributed_rollout) | 1 of a [2, S] buffer a dispatch | "
              f"{tr['rollout_bytes_per_step']} a step |",
              f"| serving (AutoresetServer) | 1 of an [S, 1 + A] buffer a dispatch | "
              f"{tr['serving_bytes_per_step']:.0f} a step |",
              f"| PPO train step (E={r['ppo_envs']}, T=16, 2x2 minibatches) | "
              f"{tr['all_reduces_per_train_step']}: {n_mb} of the gradients "
              f"({tr['grad_bytes']} B = {tr['param_count']} params), {2 * n_mb} of advantage "
              f"statistics, 1 of the metrics | {tr['bytes_per_train_step']} |",
              "", f"The cost of one all-reduce ({r['calls']}-deep chain minus the identity "
              f"chain, best of {r['reps']}):", "", "| payload | per all-reduce |",
              "|---|---:|"]
    lines += [f"| {c['payload']} ({c['bytes']} B) | {c['per_all_reduce_us']:.2f} us |"
              for c in r["chains"]]
    lines += ["", "The sharded PPO step against the same step on a mesh whose psum is the "
              "identity (timing only):", "", "| variant | train-step wall |", "|---|---:|"]
    lines += [f"| {p['variant']} | {p['train_step_s'] * 1e3:.3f} ms |" for p in r["ppo"]]
    lines += ["", f"-> {r['overhead_s'] * 1e3:.3f} ms of collectives a train step; the "
              f"chains predict {r['predicted_overhead_s'] * 1e3:.3f} ms.", "",
              "### Projection over NVLink", "",
              f"Ring all-reduce: time(G, D) = 2(D-1) hops + 2G(D-1)/D over "
              f"{NVLINK_BYTES_PER_S / 1e9:.0f} GB/s ({r['link']}); the hop from this run's "
              f"1-element all-reduce over {r['backend']}.  Against this run's 1-rank steps: "
              f"PPO {r['one_rank']['ppo_step_s'] * 1e3:.3f} ms, serving "
              f"{r['one_rank']['serving_step_s'] * 1e3:.4f} ms a step at E={r['envs']}.", "",
              "| ranks | hop | gradient all-reduce | PPO overhead | PPO eff. | serving eff. |",
              "|---:|---:|---:|---:|---:|---:|"]
    lines += [f"| {p['ranks']} | {p['hop_us']:.2f} us | {p['grad_all_reduce_us']:.1f} us | "
              f"{p['ppo_overhead_us']:.1f} us | {p['ppo_projected_efficiency'] * 100:.2f} % | "
              f"{p['serving_projected_efficiency'] * 100:.3f} % |" for p in r["projection"]]
    lines.append("")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write("\n".join(lines))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank_job:
        return rank_main(args)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
