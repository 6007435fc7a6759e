#!/usr/bin/env python3
"""Train a LearningPolicy agent with the PyTorch port's on-device PPO.

The counterpart of ``scripts/train_ppo.py`` for
``gym_collision_avoidance_torch``: rollout (auto-reset in the loop), GAE and
every optimizer epoch run on the CUDA card, one ``train_step`` per
iteration.  Same flags, except that ``--device {cuda,cpu}`` (default
``cuda``, which fails without a card) replaces ``--cpu``.  ``--devices N``
trains data-parallel over N ranks, one per card (``cuda:<rank>``, NCCL; with
``--device cpu``, N gloo CPU ranks), through
``train.ppo.make_sharded_ppo``: the script starts the N ranks itself, or runs
as one of them under ``torchrun --nproc-per-node N``.  Only rank 0 prints and
exports.  ``--save``/``--resume`` write and read the whole training
carry and the noise generator as one file (``utils/checkpoint.py``), the
ranks' env rows gathered in global order
(``parallel.distributed.save_sharded_state``), so a resumed run continues
bitwise at the same ``--devices`` and loads at any other that divides
``--envs``; ``--init-params``/``--export-params`` read and write the
JAX package's parameter ``.npz`` (``convert.ppo_params_*``), so a net moves
between the two packages either way.

Usage:
  python scripts/train_ppo_torch.py [--iters 50] [--envs 1024] [--horizon 64]
      [--agents 2] [--traffic noncoop|rvo] [--arch mlp|ga3c|drl_long]
      [--self-play] [--device cuda|cpu] [--devices N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_agents_mix(text: str):
    """``'3, 4,10'`` -> ``[3, 4, 10]``; an empty segment is an error."""
    counts = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            raise argparse.ArgumentTypeError(f"empty agent count in {text!r}")
        try:
            counts.append(int(part))
        except ValueError:
            raise argparse.ArgumentTypeError(f"agent count {part!r} in {text!r} is not an "
                                             "integer") from None
    return counts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--traffic", default="noncoop", choices=["noncoop", "rvo"])
    ap.add_argument("--arch", default="mlp", choices=["mlp", "ga3c", "drl_long"],
                    help="mlp: Gaussian MLP on the [0,1]^2 action box; ga3c: the "
                         "GA3C-CADRL LSTM net with its 11 discrete actions; drl_long: "
                         "the DRL-Long laserscan CNN on the 3-deep scan stack")
    ap.add_argument("--self-play", action="store_true",
                    help="every agent runs (and trains) the shared net; --traffic is "
                         "then unused")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (init and noise; the scenario pool keeps its own "
                         "fixed seed)")
    ap.add_argument("--entropy", type=float, default=None,
                    help="entropy bonus coefficient (default: PPOConfig's 1e-3; the "
                         "drl_long recipe uses 0)")
    ap.add_argument("--shaping", type=float, default=0.3,
                    help="training-side progress-shaping coefficient")
    ap.add_argument("--pool-cases", type=int, default=256,
                    help="scenario pool size for the auto-reset")
    ap.add_argument("--agents-mix", type=parse_agents_mix, default=None, metavar="N,N,...",
                    help="comma-separated agent counts for a mixed-density pool (e.g. "
                         "'3,4,10'), padded to the max with inert agents; overrides --agents")
    ap.add_argument("--pool-side", type=float, default=4.0,
                    help="scenario side length (4.0 matches the frozen evaluation suites)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the env axis over N ranks, one per card (NCCL), or N gloo "
                         "ranks with --device cpu; --envs is the global count")
    # set by the parent for each rank it starts (parallel.distributed.spawn_local)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="save the training carry and noise generator here at the end "
                         "(and every 20 iterations), the env rows of every rank in one file")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume from a --save file, saved at any --devices that divides "
                         "--envs (a bitwise continuation at the same --devices)")
    ap.add_argument("--init-params", default=None, metavar="PATH",
                    help="(--arch ga3c/drl_long) warm-start the net from a parameter .npz "
                         "(this script's or scripts/train_ppo.py's --export-params) with a "
                         "fresh optimizer and fresh envs")
    ap.add_argument("--export-params", default=None, metavar="PATH",
                    help="(--arch ga3c/drl_long) write the trained net as a parameter .npz "
                         "in the JAX package's names and layout")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.arch not in ("ga3c", "drl_long"):
        for flag in ("init_params", "export_params"):
            if getattr(args, flag):
                ap.error(f"--{flag.replace('_', '-')} requires --arch ga3c or drl_long")
    if args.envs % args.devices:
        ap.error(f"--envs {args.envs} does not split over --devices {args.devices}")
    ranked = args.process_id is not None or "WORLD_SIZE" in os.environ
    if args.devices > 1 and not ranked:
        return spawn_ranks(args, argv)

    import numpy as np
    import torch

    from gym_collision_avoidance_torch import convert
    from gym_collision_avoidance_torch.core.device import card_label, resolve_device
    from gym_collision_avoidance_torch.policies import registry as P
    from gym_collision_avoidance_torch.scenarios import random_cases
    from gym_collision_avoidance_torch.parallel import distributed as dist
    from gym_collision_avoidance_torch.parallel.mesh import EnvMesh
    from gym_collision_avoidance_torch.train import PPOConfig, make_ppo, make_sharded_ppo
    from gym_collision_avoidance_torch.train.ppo import CARRY_ENV_ROWS, trainable_params

    device = resolve_device(args.device)
    mesh = None
    if args.devices > 1:
        check_visible(args)
        dist.init_distributed({"cuda": "nccl", "cpu": "gloo"}[args.device],
                              num_processes=args.num_processes, process_id=args.process_id,
                              init_method=args.init_method)
        mesh = dist.global_mesh(args.device)
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    if args.agents_mix:
        args.agents = max(args.agents_mix)
        pool = random_cases.scenario_pool_mixed(args.pool_cases, args.agents_mix, seed=0,
                                                side_length=args.pool_side)
    else:
        pool = random_cases.scenario_pool(args.pool_cases, args.agents, seed=0,
                                          side_length=args.pool_side)
    ppo = PPOConfig(
        num_envs=args.envs, horizon=args.horizon, num_agents=args.agents, lr=args.lr,
        traffic_policy={"noncoop": P.NONCOOP, "rvo": P.RVO}[args.traffic],
        policy_arch=args.arch, self_play=args.self_play, shaping_coef=args.shaping,
        seed=args.seed, **({} if args.entropy is None else {"entropy_coef": args.entropy}),
    )
    if mesh is None:
        step, init_fn, obs_dim = make_ppo(ppo, pool=pool, device=device)
    else:
        step, init_fn, obs_dim = make_sharded_ppo(ppo, mesh, pool=pool)
    carry = init_fn(ppo.seed)
    # every rank draws the same global noise and reads its rows of it
    gen = torch.Generator(device).manual_seed(ppo.seed + 7)
    label = card_label(device)
    say = print if lead else (lambda *a, **k: None)
    say(f"obs_dim={obs_dim} envs={args.envs} horizon={args.horizon} "
        f"agents={args.agents} traffic={args.traffic} devices={args.devices} device={label}")

    ranks = mesh or EnvMesh(device)
    if args.resume:
        *carry, gen = dist.load_sharded_state(args.resume, tuple(carry) + (gen,),
                                              CARRY_ENV_ROWS, ranks)
        say(f"resumed from {args.resume}")
    elif args.init_params:
        with np.load(args.init_params) as z:
            arrays = {k: z[k] for k in z.files}
        if set(arrays) != set(trainable_params(carry[0])):
            sys.exit(f"{args.init_params}: parameter names differ from the {args.arch} net's")
        # the net only: the fresh optimizer state (zero moments, step 0) and
        # fresh envs stay, the curriculum recipe of scripts/train_ppo.py
        carry = [convert.ppo_params_from_numpy(args.arch, arrays, device)] + list(carry[1:])
        say(f"warm-started params from {args.init_params}")

    carry = list(carry)
    t0 = time.time()
    steps_done = 0
    for i in range(args.iters):
        *carry, m = step(*carry, rng=gen)
        steps_done += args.envs * args.horizon
        if args.save and i and i % 20 == 0:
            dist.save_sharded_state(args.save, tuple(carry) + (gen,), CARRY_ENV_ROWS, ranks)
        if i % max(1, args.iters // 20) == 0 or i == args.iters - 1:
            dt = time.time() - t0
            say(f"iter {i:4d}  return/ep {float(m['mean_return_per_episode']):+.3f}"
                f"  episodes {float(m['episodes_finished']):.0f}"
                f"  clip {float(m['clip_frac']):.3f}"
                f"  env-steps/s {steps_done / dt:.3g} ({label})", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    say(f"total: {steps_done} env-steps in {dt:.1f}s = {steps_done / max(dt, 1e-9):.3g} "
        f"env-steps/s on {args.devices} x {label}")
    if args.save:
        dist.save_sharded_state(args.save, tuple(carry) + (gen,), CARRY_ENV_ROWS, ranks)
        say(f"saved {args.save}")
    if args.export_params and lead:
        np.savez(args.export_params, **convert.ppo_params_to_numpy(args.arch, carry[0]))
        print(f"exported {args.export_params}")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


def check_visible(args):
    """Raise unless ``--devices`` cards are visible (with ``--device cuda``)."""
    import torch

    if args.device == "cuda" and torch.cuda.device_count() < args.devices:
        raise RuntimeError(f"--devices {args.devices}, but {torch.cuda.device_count()} CUDA "
                           "cards are visible")


def spawn_ranks(args, argv) -> int:
    """Start ``--devices`` ranks of this script with the same flags and wait
    for them."""
    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.parallel import distributed as dist

    resolve_device(args.device)
    check_visible(args)
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        dist.spawn_local([sys.executable, os.path.abspath(__file__), *argv], args.devices,
                         threads=None if args.device == "cuda" else 1)
    except dist.RankFailed as err:
        print(err, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
