#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc`` under ``/usr/local/cuda`` or on ``PATH``)::

    python3 chip_smoke.py

It builds every hand-written kernel of the port from ``csrc/`` (one ``nvcc``
for each source, all started together) and holds each against its plain
PyTorch version on the card.  K2 and K3 are held on the seeded edge cases
of ``tests/test_torch_raymarch_band.py`` and
``tests/test_torch_laser_fused_band.py`` too (tangent beams, cell
boundaries, map edges, hosts inside discs, map 002, in both dtypes), and
those files' models of the kernels' designs count the work behind their
bounds.  Every kernel row also carries the launch floor: the device time of
one ``fill_`` of K1's output bytes, the least a launch costs in a CUDA
graph.  K1 is held and timed alone and with its reward epilogue (the env
step's whole reward stage, the one launch ``_compute_rewards`` makes), each
in its layout and one thread a row, at ``[16384, 4]``, ``[256, 20]`` and
``[512, 40]``, beside the previous route (K1, then the plain reward chain's
launches), and the main path runs on both routes in turns (previous, fused,
fused, previous: env-steps/s and one traced dispatch each, kernels a step
and the kernels only one route launches).  Every in-path capture below
holds K1's four outputs (collision, nearest gap, reward, latched
``in_collision``) bitwise.  SA-CADRL's value-net kernel (``csrc/cadrl_value.cu``,
which replaces no Pallas kernel) is held against its plain version at tile
edges in both dtypes and bitwise at cadrl4's row counts, and timed at
``cadrl4.serve16k``'s rows a step beside its operations bound and the plain
version; the cadrl4 path must launch it once a step.  DRL-Long's
convolution kernel (``csrc/drl_long_conv.cu``, which replaces no Pallas
kernel either) is held against its plain version (cuDNN's convolutions, bias
adds and ReLUs) at ragged row counts and scan lengths in both dtypes,
bitwise in float32 at 512 beams, and timed at ``drl_long4.serve16k``'s rows
a step beside its operations bound; the drl2 and eval_drl_long paths must
launch it once a step.  Then it drives the port's paths through
``AutoresetServer``, each with the kernel launch counts set to 0 just before
and read just after:

* the main path: the 4-agent NonCoop auto-reset serving loop that
  ``bench.py`` times, at E = 16384 envs (kernel K1);
* ga3c4: ``scripts/bench_all.py``'s ``bench_ga3c4_serving``, 4 GA3C-CADRL
  agents with the iros18 weights, E = 4096 (K1);
* orca4: its ``bench_orca4``, 4 RVO agents, E = 16384 (K1);
* the laser path, full pass: the ``ga3c20_laser`` configuration (20
  GA3C-CADRL agents, 512 beams, the empty 20 x 20 m map, E = 256) with no
  fast route (kernels K1 and K2);
* the laser path, fast route: the same with its wedge culling, 12-sample
  windows and 4 beam slots (kernels K1 and K3);
* cadrl4: ``scripts/bench_all.py``'s ``bench_cadrl4``, 4 SA-CADRL agents on
  the 3 m circle with the ``no_constr`` value net, E = 4096 (K1);
* drl2: ``scripts/eval_drl_long.py``'s world, a DRL-Long agent (the shipped
  ``drl_long_2agent_rvo_tpu`` net) against an RVO agent on the empty
  16 x 16 m map, 512 beams, the full pass, E = 4096 (kernels K1 and K2).

It trains with the port's PPO trainer on the three training paths of
``harness/paths.py``, each at its recipe's width, the kernel counts set to 0
after a warm-up iteration and read after the timed ones:

* train_ga3c4: stage 3 of ``scripts/train_curriculum.sh``, GA3C-CADRL
  self-play with 4 agents, E = 256, T = 64, warm-started from
  ``ppo_selfplay_4agent_curr`` (K1);
* train_drl2: ``RESULTS.md``'s DRL-Long recipe against RVO, E = 1024, T = 64,
  512 beams, no static cell (K1 and K2, which is also held bitwise against
  its plain version on one rollout step's arguments);
* train_mlp2: ``README.md``'s MLP example against RVO, E = 1024, T = 64 (K1).

Each reports ms per iteration split into rollout, GAE and update,
env-steps/s, and one traced iteration's kernels and idle share.  The phases
of one ``train_step`` of each path at E = 64, T = 16 on the card are held
against the CPU's, every rollout step and every minibatch step from the
CPU's inputs with the same noise (:func:`compare_training`), and two
iterations of train_ga3c4 and train_drl2 from one seed must give the same
bits twice.

It runs the evaluation campaign's 4-agent cells (``harness/paths.py``'s
``SUITE_PATHS``): the 500 frozen cases of CADRL, RVO and GA3C-CADRL-10, each
as one batch through ``harness/experiments.py:run_batched_episodes`` (K1 once
a lockstep step), held against the JAX package's per-episode outcomes in
``tests/data/torch_suite_jax_outcomes.json`` (every outcome equal, step
counts equal on all but 2% of the episodes), every differing episode
replayed on the card and the CPU to the step at which the two part.  Two
controls show that this gate rejects GA3C-CADRL-10 with bf16 weights and
with TF32 products.  K1's launches in the first 2 steps of every cell of the
campaign (2, 3 and 4 agents) are held bitwise.  Then it drives the gym env
(``env/gymapi.py``) on the card against the CPU, K1 held bitwise at
``[1, A]``.  Last, it re-runs itself as ranks of ``torch.distributed``
(``--rank-job``): 2 gloo ranks sharing the card (NCCL refuses two ranks on
one card; the backend is chosen here, never by a fallback) run the main
path's server (K1 counted on each rank and held bitwise at ``[8192, 4]``),
one ga3c4 dispatch with the weights broadcast from rank 0, a distributed
rollout and train_mlp2's sharded trainer, each held against one rank on the
card; 1 NCCL rank runs the same rollout.  The strict-parity route runs
card against CPU.  Each phase prints its seconds.

Then the JAX repo's entry points as the port runs them, each with the launch
counts set to 0 before and read after, and the card's ``nvidia-smi`` line
beside its numbers:

* eval_drl_long: ``scripts/eval_drl_long_torch.py`` at the script's width
  (the shipped DRL-Long net against RVO, the 500 frozen 2-agent cases,
  E = 500, 250 steps; K1 and K2), every case's outcome held against the JAX
  script's (``tests/data/torch_drl_long_jax_outcomes.json``), a differing
  case replayed and failing the phase;
* eval_trained_net: ``scripts/eval_trained_net_torch.py`` on the shipped
  flagship ``ppo_selfplay_10agent_tpu`` over the 2-, 3- and 4-agent cells
  (K1), held against the JAX package's outcomes by ``compare_outcomes``; and
  the net the train_ga3c4 phase trained, exported and scored on the 4-agent
  cell;
* reinforce: ``scripts/train_example_torch.py`` at its defaults (E = 256,
  T = 40; K1), one iteration held against the CPU's from the same draws,
  then timed iterations;
* sharded_resume (in the rank jobs, 2 gloo ranks and 1 NCCL rank):
  train_mlp2's trainer for 2 iterations against 1, a save, a resume and 1
  more, bitwise in every leaf of the saved carry;
* scaling: the multi-device entry points.  ``entry.entry()``'s step of 8
  GA3C-CADRL envs against the CPU's; ``entry.dryrun_multichip`` on 1 NCCL
  rank and on 2 gloo ranks sharing the card (its rank body also runs in the
  rank jobs, K1 held at [2, 4]); ``scripts/scaling_bench_torch.py`` at 1
  NCCL rank and at 1-2 gloo ranks, ``scripts/collective_overhead_torch.py``
  on 2 gloo ranks and ``scripts/scaling_multiproc_torch.py`` at 1 rank over
  gloo and NCCL and 2 gloo ranks, all at small sizes, each rank's launches
  counted.  Ranks that share the card measure the collectives' overhead,
  not scaling.

K1's (and on eval_drl_long K2's) first launches in each are held bitwise.

Then the benchmark's rows (bench_rows): every row of
``scripts/bench_all_torch.py`` once at the env count the JAX repo runs it at,
8 steps a dispatch, counts from 0 before each row (K1 once a step, K3 once a
step on ga3c20_laser), ga3c40's first K1 launches held bitwise at
``[512, 40]``, the host reads inside each timed window counted a step; and
``bench_torch.py``'s exactness tripwire, which must pass clean and trip with
TF32 products on.

It checks the fast route against the full pass wherever its exactness guard
is quiet, and one env step on the card against the same step on the CPU,
each env on its own pool case: on the main path, on ga3c4, orca4, cadrl4
and drl2 (GA3C and SA-CADRL action indices, DRL-Long actions, ORCA
velocities and LP branches) and on both laser routes.  Every phase raises
on failure, so the exit code is 0 only if all passed.  The last three lines
of its output are the kernels' JSON summary (with each kernel's launches on
every path), the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  It imports nothing of
JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (the card's power limit is printed beside them).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # float32 outside the tensor cores

DEVICE = "cuda"
# the main path's width (gym_collision_avoidance_torch/harness/paths.py
# defines every path; these are the kernels' shapes on two of them)
E_MAIN, A_MAIN = 16384, 4
STEPS_PER_DISPATCH, DISPATCHES = 128, 4
# the laser path (scripts/bench_all.py:bench_ga3c20_laser: 4096 // 16 envs)
E_LASER, A_LASER, L_LASER = 256, 20, 512
LASER_STEPS, LASER_DISPATCHES = 64, 4
E_DRL2_STEP = 64       # envs of drl2's whole compared step
POLICY_STEPS, POLICY_DISPATCHES = 64, 3
KERNEL_SOURCES = ("pairwise", "raymarch", "laser_fused", "cadrl_value", "drl_long_conv")
# timed iterations of each training path (after one warm-up), and the size of
# the card-against-CPU training step
TRAIN_ITERS = {"train_ga3c4": 3, "train_drl2": 3, "train_mlp2": 1}
E_TRAIN_CMP, T_TRAIN_CMP = 64, 16
TRAIN_CHECK_STEPS = 2  # rollout steps whose K1/K2 launches are held bitwise
# the CPU tests' tolerances (tests/test_torch_ppo.py)
ROLL_TOL = dict(rtol=1e-5, atol=2e-6)
GAE_TOL = dict(rtol=1e-5, atol=1e-5)
# a minibatch's gradients on the card against the CPU's from the same weights
# and samples, each entry within this share of its tensor's largest CPU entry
# (tests/test_torch_train_cuda.py's limit), once the rows that took another
# side of a kink on the card are left out (compare_training)
GRAD_TOL = 1e-4
METRICS_TOL = dict(rtol=1e-5, atol=1e-6)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps=21, inner=20, warmup=5):
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, divided by ``inner``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def graph_ms(fn, inner=20):
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    the graph's replays timed by :func:`median_ms`, so the host's launch
    overhead (Python, ctypes, allocation) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return median_ms(graph.replay, inner=1) / inner


def max_abs_err(a, b):
    """Largest |a - b|, NaN where both are NaN counted as equal; raises if
    only one side is NaN."""
    a, b = a.double().cpu(), b.double().cpu()
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN pattern differs")
    ok = ~torch.isnan(a)
    return float((a[ok] - b[ok]).abs().max()) if ok.any() else 0.0


def pairwise_inputs(seed, E, A, dtype, device, nan=False):
    """Seeded K1 inputs: ~20% invalid agents, exactly-touching pairs."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-3, 3, (E, A, 2))
    radius = rng.uniform(0.3, 1.2, (E, A))
    valid = rng.rand(E, A) > 0.2
    # every fourth env: agents 0 and 1 touch (3-4-5 triangle, radii 2 + 3)
    pos[::4, 1] = pos[::4, 0] + np.array([3.0, 4.0])
    radius[::4, 0], radius[::4, 1] = 2.0, 3.0
    if nan:
        pos[0, 1, 1] = np.nan
    return (torch.tensor(pos, dtype=dtype, device=device),
            torch.tensor(radius, dtype=dtype, device=device),
            torch.tensor(valid, device=device))


def phase_build(build):
    """Build every kernel, one nvcc per source, all started together."""
    t0 = time.perf_counter()
    build.build(KERNEL_SOURCES)
    print(f"build: {', '.join(n + '.cu' for n in KERNEL_SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def reward_inputs(seed, E, A, dtype, device, nan=False, wall=False):
    """Seeded arguments of ``pairwise_rewards``: K1's inputs
    (:func:`pairwise_inputs`), ~20% of agents at their goal, ~15% in
    collision, random past actions and, if ``wall``, a wall mask on ~10%;
    the config turns wiggly turns on, so every branch of the chain is taken."""
    from gym_collision_avoidance_torch import EnvConfig

    pos, radius, valid = pairwise_inputs(seed, E, A, dtype, device, nan)
    rng = np.random.RandomState(seed + 1)
    at_goal, in_coll = rng.rand(E, A) < 0.2, rng.rand(E, A) < 0.15
    # is_at_goal, was_at_goal_already, was_in_collision_already, in_collision
    flags = [torch.tensor(f, device=device) for f in (
        at_goal, at_goal & (rng.rand(E, A) < 0.5), in_coll & (rng.rand(E, A) < 0.5), in_coll)]
    past = torch.tensor(rng.uniform(-1, 1, (E, A, 3, 2)), dtype=dtype, device=device)
    mask = torch.tensor(rng.rand(E, A) < 0.1, device=device) if wall else None
    cfg = EnvConfig(dtype=str(dtype)[6:], reward_wiggly_behavior=-0.2,
                    wiggly_behavior_threshold=0.3)
    return (pos, radius, valid, *flags, past, mask, cfg)


def hold_k1(plain, args, outs, what):
    """K1's outputs ``outs`` on ``args`` against ``plain(*args)`` (K1's
    ``pairwise_collisions_plain``, or ``pairwise_rewards_plain`` for the
    launch with the reward epilogue): flags equal, nearest gaps and rewards
    bitwise equal (NaN where the plain version has NaN); returns the
    largest float difference."""
    want = plain(*args)
    check(len(outs) == len(want), f"K1 returned {len(outs)} outputs ({what})")
    worst = 0.0
    for k, (got, ref) in enumerate(zip(outs, want)):
        check(got.dtype == ref.dtype and got.shape == ref.shape,
              f"K1 output {k}: {got.dtype} {tuple(got.shape)} ({what})")
        if got.dtype == torch.bool:
            check(torch.equal(got, ref), f"K1 output {k}: flags differ ({what})")
            continue
        finite = ~torch.isnan(ref)
        check(torch.equal(torch.isnan(got), ~finite), f"K1 output {k}: NaN pattern differs ({what})")
        itype = torch.int32 if got.dtype == torch.float32 else torch.int64
        check(torch.equal(got[finite].view(itype), ref[finite].view(itype)),
              f"K1 output {k} not bitwise equal ({what})")
        worst = max(worst, max_abs_err(got, ref))
    return worst


def moved_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# K1's shapes: the main path, the laser path (with its map's wall mask),
# LargeNumAgents (scripts/bench_all.py's ga3c40), and, for the layout sweep,
# ga3c4's and cadrl4's [4096, 4] and the 2-agent training paths' [1024, 2]
K1_SHAPES = ((E_MAIN, A_MAIN, False), (E_LASER, A_LASER, True), (512, 40, False),
             (4096, 4, False), (1024, 2, False))
K1_LANES = (1, 2, 4, 8, 16, 32)     # threads a row, in the layout sweep


def previous_reward_route(pairwise):
    """The reward stage as the port ran it before the epilogue was fused:
    K1's kernel, then the plain chain as separate launches on the card.
    Composed here only, to measure against."""
    def route(*args):
        coll, near = pairwise.pairwise_collisions_cuda(*args[:3])
        return (coll, near, *pairwise.reward_chain_plain(coll, near, *args[2:]))
    return route


def time_k1_shape(pairwise, E, A, wall):
    """Device ms (CUDA-graph replay) and bytes bounds of K1 alone and of its
    launch with the reward epilogue, in the layout ``lanes_for`` picks and in
    every layout of K1_LANES (each held bitwise first), of both plain
    versions and of the previous route, on seeded inputs of shape
    ``[E, A]``."""
    args = reward_inputs(8, E, A, torch.float32, DEVICE, wall=wall)
    k1_args = args[:3]
    layouts = {}
    for lanes in K1_LANES:
        hold_k1(pairwise.pairwise_collisions_plain, k1_args,
                pairwise.pairwise_collisions_cuda(*k1_args, lanes=lanes),
                f"E={E} A={A} lanes={lanes}")
        hold_k1(pairwise.pairwise_rewards_plain, args,
                pairwise.pairwise_rewards_cuda(*args, lanes=lanes),
                f"rewards E={E} A={A} lanes={lanes}")
        layouts[lanes] = {
            "k1_ms": graph_ms(lambda: pairwise.pairwise_collisions_cuda(*k1_args, lanes=lanes)),
            "fused_ms": graph_ms(lambda: pairwise.pairwise_rewards_cuda(*args, lanes=lanes))}
    previous = previous_reward_route(pairwise)
    line = {"shape": [E, A], "wall": wall, "lanes": pairwise.lanes_for(A),
            "k1_ms": graph_ms(lambda: pairwise.pairwise_collisions_cuda(*k1_args)),
            "k1_plain_ms": graph_ms(lambda: pairwise.pairwise_collisions_plain(*k1_args)),
            "fused_ms": graph_ms(lambda: pairwise.pairwise_rewards_cuda(*args)),
            "fused_plain_ms": graph_ms(lambda: pairwise.pairwise_rewards_plain(*args)),
            "previous_route_ms": graph_ms(lambda: previous(*args)), "layouts": layouts}
    coll, near, reward, latched = pairwise.pairwise_rewards_plain(*args)
    pos, radius, valid, past = args[0], args[1], args[2], args[7]
    k1_bytes = moved_bytes(pos, radius, valid, coll, near)
    # the epilogue reads the four flags, the wall mask and past_actions[..., 0, 1]
    fused_bytes = k1_bytes + moved_bytes(*args[3:7], args[8], reward, latched) + \
        E * A * past.element_size()
    # per valid ordered pair: 2 sub, 2 mul, add, sqrt, add, sub, 2 compares;
    # the epilogue about 12 a row
    n = valid.sum(dim=1)
    pair_ops = 10 * float((n * (n - 1)).sum())
    for key, nbytes, ops in (("k1", k1_bytes, pair_ops),
                             ("fused", fused_bytes, pair_ops + 12 * E * A)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
        line[f"{key}_bytes"] = nbytes
        line[f"{key}_bound_ms"] = max(t_bytes, t_ops) * 1e3
        line[f"{key}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return line


def phase_kernels(pairwise):
    """Hold K1 bitwise against its plain version, alone and with its reward
    epilogue (the launch the env step makes); time both at K1_SHAPES in
    every layout, on the device (CUDA graph replay) and, at the main path's
    shape, as eager calls beside the previous route (K1, then the plain
    chain)."""
    worst = 0.0
    cases = [(torch.float32, E_MAIN, A_MAIN, False), (torch.float32, 512, 40, False),
             (torch.float64, 64, 4, False), (torch.float32, 64, 4, True)]
    for dtype, E, A, nan in cases:
        args = pairwise_inputs(7, E, A, dtype, DEVICE, nan)
        coll, near = pairwise.pairwise_collisions(*args)
        torch.cuda.synchronize()
        worst = max(worst, hold_k1(pairwise.pairwise_collisions_plain, args, (coll, near),
                                   f"{dtype} E={E} A={A} nan={nan}"))
        if not nan:
            touching = args[2][::4, 0] & args[2][::4, 1]
            check(bool(coll[::4, 0][touching].all()), "touching pairs must collide")
        print(f"K1 {str(dtype)[6:]} E={E} A={A} nan={nan}: bitwise equal", flush=True)
    reward_cases = [(torch.float32, E_MAIN, A_MAIN, False, False),
                    (torch.float32, E_LASER, A_LASER, False, True),
                    (torch.float32, 512, 40, False, False), (torch.float32, 64, 2, False, True),
                    (torch.float64, 64, 4, False, True), (torch.float64, 512, 40, False, False),
                    (torch.float32, 64, 4, True, True), (torch.float64, 64, 4, True, False)]
    for dtype, E, A, nan, wall in reward_cases:
        args = reward_inputs(7, E, A, dtype, DEVICE, nan, wall)
        before = pairwise.LAUNCHES
        outs = pairwise.pairwise_rewards(*args)
        torch.cuda.synchronize()
        check(pairwise.LAUNCHES == before + 1, "pairwise_rewards: one launch")
        worst = max(worst, hold_k1(pairwise.pairwise_rewards_plain, args, outs,
                                   f"rewards {dtype} E={E} A={A} nan={nan} wall={wall}"))
        check(outs[3] is not args[6], "the latch must be a new tensor")
        print(f"K1 with rewards {str(dtype)[6:]} E={E} A={A} nan={nan} wall={wall}: "
              f"bitwise equal", flush=True)

    shapes = [time_k1_shape(pairwise, E, A, wall) for E, A, wall in K1_SHAPES]
    main = shapes[0]
    # the least one launch costs: a fill of K1's output bytes, in a graph
    floor_buf = torch.empty(E_MAIN * A_MAIN * 5, dtype=torch.uint8, device=DEVICE)
    launch_floor_ms = graph_ms(lambda: floor_buf.fill_(0))
    # the same calls issued eagerly at the main path's shape, host overhead included
    args = reward_inputs(8, E_MAIN, A_MAIN, torch.float32, DEVICE)
    previous = previous_reward_route(pairwise)
    eager = {"k1_eager_ms": median_ms(lambda: pairwise.pairwise_collisions_cuda(*args[:3])),
             "fused_eager_ms": median_ms(lambda: pairwise.pairwise_rewards_cuda(*args)),
             "previous_route_eager_ms": median_ms(lambda: previous(*args)),
             "fused_plain_eager_ms": median_ms(lambda: pairwise.pairwise_rewards_plain(*args))}
    summary = {"kernel": "pairwise_collisions", "launch_floor_ms": launch_floor_ms,
               "library_ms": None, "launches_per_step": 1, **eager, "by_shape": shapes}
    print(json.dumps(summary), flush=True)
    return {"name": "pairwise_collisions", "route": "cuda",
            "source": "gym_collision_avoidance_torch/csrc/pairwise.cu",
            "replaces": "gym_collision_avoidance_tpu/ops/pairwise.py:77",
            "entry": "pairwise_rewards (K1 with the reward epilogue, at the main path's shape)",
            "launches": None, "max_abs_err": worst, "ms": main["fused_ms"],
            "plain_ms": main["fused_plain_ms"], "bound_ms": main["fused_bound_ms"],
            "bound_by": main["fused_bound_by"], "library_ms": None,
            "launch_floor_ms": launch_floor_ms,
            "k1_alone": {k[3:]: main[k] for k in ("k1_ms", "k1_plain_ms", "k1_bound_ms",
                                                  "k1_bound_by")},
            "by_shape": shapes}


def serving_path(name):
    """The path ``name`` of ``gym_collision_avoidance_torch/harness/paths.py``
    with its weights and map on the card."""
    from gym_collision_avoidance_torch.harness import paths

    return paths.serving_path(name, DEVICE)


def phase_serving(name, kernels, path, laser=None, steps=STEPS_PER_DISPATCH,
                  dispatches=DISPATCHES):
    """Drive ``path``'s AutoresetServer at its full width; the counts go to
    0 after construction, and K1 must launch once per step, the ``laser``
    kernel (``"raymarch"`` or ``"laser_fused"``) once per step if given, and
    no other laser kernel."""
    server = path.server(steps_per_dispatch=steps, device=DEVICE)
    num_envs, policy_id = path.num_envs, path.policy_id
    torch.cuda.synchronize()
    for k in kernels.values():
        k.LAUNCHES = 0
    server.dispatch()                                   # warm-up dispatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(dispatches):
        out = server.dispatch()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: k.LAUNCHES for n, k in kernels.items()}
    total = (dispatches + 1) * steps
    check(launches["pairwise"] == total,
          f"{name}: K1 launched {launches['pairwise']} times in {total} steps")
    for kernel in ("raymarch", "laser_fused"):
        want = total if kernel == laser else 0
        check(launches[kernel] == want,
              f"{name}: {kernel} launched {launches[kernel]} times, not {want}")

    for leaf_name, leaf in server.states().items():
        if leaf.is_floating_point():
            check(bool(torch.isfinite(leaf).all()), f"{name}: non-finite state leaf {leaf_name}")
    check(bool(torch.isfinite(out["mean_reward"]).all()), f"{name}: non-finite reward")
    episodes = server.episodes_completed()
    check(episodes > 0, f"{name}: no episode completed")
    timed = dispatches * steps
    line = {"num_envs": num_envs, "agents": len(policy_id), "steps": total, "timed_steps": timed,
            "seconds": seconds, "env_steps_per_s": timed * num_envs / seconds,
            "ms_per_step": 1e3 * seconds / timed, "episodes_completed": episodes,
            "launches": launches}
    if "laserscan" in path.sensors:
        line["beams"] = path.cfg.laserscan_length
    if "exactness_overflow" in out:
        line["exactness_overflow"] = server.exactness_overflow()
        line["steps_with_overflow"] = int(out["exactness_overflow"].sum())
    print(json.dumps({name: line}), flush=True)
    return launches, server.states()


AB_STEPS, AB_DISPATCHES = 32, 3     # per turn of the reward-route A/B


@contextlib.contextmanager
def reward_route(pairwise, route):
    """Run the block with ``pairwise.pairwise_rewards_cuda`` replaced by
    ``route``."""
    orig = pairwise.pairwise_rewards_cuda
    pairwise.pairwise_rewards_cuda = route
    try:
        yield
    finally:
        pairwise.pairwise_rewards_cuda = orig


def traced_dispatch(server, steps):
    """Kernels a step, device busy ms a step and kernel counts by name of
    one traced dispatch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.dispatch()
        torch.cuda.synchronize()
    # the device-side copies of the port's gca.* spans are no kernels
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("gca.")]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + 1
    return {"kernels_per_step": len(kernels) / steps,
            "device_busy_ms_per_step": sum(e.time_range.elapsed_us() for e in kernels)
            / 1e3 / steps}, by_name


def phase_reward_ab(pairwise):
    """The main path's server with the reward stage on the previous route
    (K1's kernel, then the plain chain's launches) and on the fused launch,
    in turns (previous, fused, fused, previous): env-steps/s of each turn,
    then one traced dispatch of each route (kernels and device busy ms a
    step, and the kernels by name that only one route launches)."""
    routes = {"previous": previous_reward_route(pairwise),
              "fused": pairwise.pairwise_rewards_cuda}
    server = serving_path("main").server(steps_per_dispatch=AB_STEPS, device=DEVICE)
    num_envs = serving_path("main").num_envs
    rates = {name: [] for name in routes}
    for name in ("previous", "fused", "fused", "previous"):
        with reward_route(pairwise, routes[name]):
            server.dispatch()                           # warm-up after the switch
            torch.cuda.synchronize()
            pairwise.LAUNCHES = 0
            t0 = time.perf_counter()
            for _ in range(AB_DISPATCHES):
                server.dispatch()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            steps = AB_DISPATCHES * AB_STEPS
            check(pairwise.LAUNCHES == steps,
                  f"reward A/B {name}: K1 launched {pairwise.LAUNCHES} times in {steps} steps")
            rates[name].append(steps * num_envs / seconds)
    traced, names = {}, {}
    for name, route in routes.items():
        with reward_route(pairwise, route):
            traced[name], names[name] = traced_dispatch(server, AB_STEPS)
    # kernels a step that one route launches more often than the other
    only = {a: {k: (n - names[b].get(k, 0)) / AB_STEPS for k, n in names[a].items()
                if names[b].get(k, 0) < n}
            for a, b in (("previous", "fused"), ("fused", "previous"))}
    check(traced["fused"]["kernels_per_step"] < traced["previous"]["kernels_per_step"],
          f"reward A/B: the fused route launches no fewer kernels: {traced}")
    ratio = float(np.mean(rates["fused"]) / np.mean(rates["previous"]))
    print(json.dumps({"reward_ab": {
        "num_envs": num_envs, "steps_per_turn": AB_DISPATCHES * AB_STEPS,
        "order": ["previous", "fused", "fused", "previous"],
        "env_steps_per_s": rates, "fused_over_previous": ratio, "traced": traced,
        "kernels_per_step_only_in": {a: {k[:80]: v for k, v in d.items()}
                                     for a, d in only.items()}}}), flush=True)


ANGLE_LEAVES = ("state.heading_ego_frame", "obs.heading_ego_frame")
LASER_LEAVES = ("state.laserscan_history", "obs.laserscan")


def compare_steps(name, cpu, card, rtol, atol, envs=None, slack=None):
    """Hold one ``env_step``'s outputs on the card against the CPU's, on the
    envs of the ``[E]`` mask ``envs`` (all by default): discrete outputs
    equal, floats within ``rtol`` / ``atol``, plus ``slack[leaf]`` (a tensor
    of the leaf's shape) where given.  The headings in the goal frame
    compare modulo 2 pi (an agent facing away from its goal sits at +-pi,
    where an ulp picks the end of the range).  Laserscan ranges must agree
    on at least 99.99% of their entries (float32 sin/cos differ by ulps
    between the devices).  Returns the largest float difference, the count
    of entries that needed their slack, the count of laser entries that
    differ and the count compared."""
    pairs = [(f"state.{k}", v, getattr(card[0], k)) for k, v in cpu[0].items()]
    pairs += [(f"obs.{k}", v, card[1][k]) for k, v in cpu[1].items()]
    pairs += [("rewards", cpu[2], card[2]), ("game_over", cpu[3], card[3])]
    pairs += [(f"info.{k}", v, card[4][k]) for k, v in cpu[4].items()]
    slack = slack or {}
    worst, slackened, laser_diff, laser_n = 0.0, 0, 0, 0
    for leaf, want, got in pairs:
        got = got.cpu()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name} {leaf} shape/dtype")
        extra = slack.get(leaf)
        if envs is not None:
            got, want = got[envs], want[envs]
            extra = None if extra is None else extra[envs]
        if leaf in LASER_LEAVES:
            laser_diff += int((got != want).sum())
            laser_n += want.numel()
        elif want.is_floating_point():
            if leaf in ANGLE_LEAVES:
                got = want + (torch.remainder(got - want + math.pi, 2 * math.pi) - math.pi)
            close = torch.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
            if extra is not None:
                loose = (got - want).abs() <= atol + rtol * want.abs() + extra
                slackened += int((loose & ~close).sum())
                close |= loose
            bad = int((~close).reshape(len(close), -1).any(dim=1).sum()) if close.dim() else 0
            check(bool(close.all()), f"{name} {leaf} differs beyond rtol {rtol} / atol {atol} "
                  f"in {bad} envs, by up to {max_abs_err(got, want)}; "
                  f"{offenders(cpu, card, envs, close, got, want)}")
            worst = max(worst, max_abs_err(got, want))
        else:
            check(torch.equal(got, want), f"{name} {leaf} differs")
    check(laser_diff <= 1e-4 * max(laser_n, 1),
          f"{name} laserscan: {laser_diff} of {laser_n} differ")
    return worst, slackened, laser_diff, laser_n


def offenders(cpu, card, envs, close, got, want, count=4):
    """The first entries outside the tolerance, with their agent's speed,
    heading and heading change on both devices, for the failure message."""
    cs, ks = cpu[0], card[0].to("cpu")
    if envs is not None:
        cs, ks = cs.map(lambda x: x[envs]), ks.map(lambda x: x[envs])
    rows = []
    for idx in (~close).nonzero()[:count].tolist():
        row = {"index": idx, "card": float(got[tuple(idx)]), "cpu": float(want[tuple(idx)])}
        if len(idx) >= 2 and cs.speed.dim() == 2 and idx[1] < cs.speed.shape[1]:
            ea = tuple(idx[:2])
            for leaf in ("speed", "heading", "delta_heading"):
                row[leaf] = [float(getattr(ks, leaf)[ea]), float(getattr(cs, leaf)[ea])]
        rows.append(row)
    return json.dumps(rows)


def goal_frame_slack(cpu, card):
    """Extra absolute tolerance for the outputs that a few ulps of position or
    heading move by more than the tolerance, from this step's own
    differences between the devices.

    Near its goal an agent's frame (``ref_prll``, ``ref_orth``: the unit
    vector to its goal) is ill-conditioned: positions a few ulps apart turn
    it by up to 2 |dpos| / dist_to_goal, and each heading relative to it
    moves by that turn, each vector projected on it by the turn times the
    vector's length.  A heading change, a heading relative to the frame,
    and a velocity by its speed times it, move by the agent's heading
    difference (the heading itself is held to the tolerance): RVO turns
    ``atan2`` into a heading in [0, 2 pi), where an ulp of ``atan2`` becomes
    several ulps of a heading near 2 pi.  That slack is granted only to an
    agent whose headings are at most 8 ulps of 2 pi apart; the leaves of
    any other agent are held without it.
    The slack is 3 times those first-order bounds (sqrt(2) for the
    max-norm, and to spare).  Returns the slack of each leaf, the largest
    turn and the count of agents whose headings are further apart."""
    cs, ks, obs = cpu[0], card[0].to("cpu"), cpu[1]
    dpos = (ks.pos - cs.pos).abs().amax(-1)                              # [E, A]
    turn = torch.maximum((ks.ref_prll - cs.ref_prll).abs(),
                         (ks.ref_orth - cs.ref_orth).abs()).amax(-1)     # [E, A]
    frame = (3 * dpos / cs.dist_to_goal.clamp(min=1e-6))[..., None]
    dh = (torch.remainder(ks.heading - cs.heading + math.pi, 2 * math.pi) - math.pi).abs()
    few_ulps = 8 * 4 * torch.finfo(cs.heading.dtype).eps                # ulp of [4, 8) is 4 eps
    apart = int((dh > few_ulps).sum())
    dh = torch.where(dh <= few_ulps, dh, torch.zeros_like(dh))
    spin = 3 * dh * cs.speed                                             # [E, A]
    others_spin = spin.amax(-1)                                          # [E]

    def projected(rows):
        """``[E, A, (K,) 7]`` sensed rows: their (x, y) and (vx, vy) pairs are
        in the host's frame, and (vx, vy) is another agent's velocity."""
        shape = turn.shape + (1,) * (rows.dim() - 3)
        t = 3 * turn.reshape(shape)
        out = torch.zeros_like(rows)
        out[..., 0:2] = (t * torch.hypot(rows[..., 0], rows[..., 1]))[..., None]
        out[..., 2:4] = (t * torch.hypot(rows[..., 2], rows[..., 3])
                         + others_spin.reshape((-1,) + (1,) * (rows.dim() - 2)))[..., None]
        return out

    speed = torch.hypot(cs.vel_ego_frame[..., 0], cs.vel_ego_frame[..., 1])
    heading = 3 * (turn + dh)
    action = torch.zeros_like(cs.past_actions)
    action[..., 1] = 3 * dh[..., None]
    slack = {"state.ref_prll": frame, "state.ref_orth": frame,
             "state.heading_ego_frame": heading,
             "state.delta_heading": 3 * dh, "state.past_actions": action,
             "state.vel": spin[..., None], "state.past_vel": spin[..., None, None],
             "state.vel_ego_frame": (3 * turn * speed + spin)[..., None],
             "state.other_agent_states": projected(cs.other_agent_states),
             "state.sensed_others": projected(cs.sensed_others)}
    if "heading_ego_frame" in obs:
        slack["obs.heading_ego_frame"] = heading[..., None]
    if "other_agents_states" in obs:
        slack["obs.other_agents_states"] = projected(obs["other_agents_states"])
    return slack, float(turn.max()), apart


def held_with_frame_slack(name, cpu, card, envs):
    """``compare_steps`` at ``phase_card_vs_cpu``'s tolerances with the goal
    frame's slack, on ``envs``; the numbers to print."""
    slack, turn, apart = goal_frame_slack(cpu, card)
    worst, slackened, laser_diff, _ = compare_steps(name, cpu, card, 1e-5, 1e-6, envs, slack)
    out = {"envs_compared": int(envs.sum()), "max_abs_err": worst,
           "largest_goal_frame_turn": turn, "entries_within_frame_slack_only": slackened,
           "agents_without_heading_slack": apart}
    if "laserscan" in cpu[1]:
        out["laser_entries_differing"] = laser_diff
    return out


def orca_times(state, cfg):
    """ms a call (CUDA events around eager calls, host launches included)
    of the ORCA solve of ``rvo_kernel`` on these states and of its LP3
    alone, which is what running LP3 on every call, without reading the
    host flag, would add where no agent needs it."""
    from gym_collision_avoidance_torch.ops import orca
    from gym_collision_avoidance_torch.policies import rvo

    args = rvo.orca_inputs(state, cfg, None)
    calls = []
    with capture(orca, "_lp3", calls):
        orca.orca_solve(*args)
    check(len(calls) == 1, "orca4: no agent reached LP3 at the compared step")
    return {"orca_solve_ms": median_ms(lambda: orca.orca_solve(*args), reps=11, inner=5),
            "lp3_alone_ms": median_ms(lambda: orca._lp3(*calls[0]), reps=11, inner=5)}


def phase_card_vs_cpu():
    """One env_step on the card and on the CPU from the same mid-episode
    states, each env on its own pool case: discrete outputs equal, floats to
    rtol 1e-5 / atol 1e-6."""
    from gym_collision_avoidance_torch.env import autoreset
    from gym_collision_avoidance_torch.harness import paths

    path = paths.serving_path("main", "cpu")
    E = 256
    state = autoreset.state_from_case(path.cfg, paths.one_case_per_env(E, A_MAIN),
                                      path.policy_id, device="cpu")
    for _ in range(15):
        state = path.step(state)[0]
    cpu = path.step(state)
    card = path.step(state.to(DEVICE))
    torch.cuda.synchronize()
    worst = compare_steps("card_vs_cpu", cpu, card, 1e-5, 1e-6)[0]
    check(bool(cpu[0].in_collision.any()) and bool(cpu[0].is_at_goal.any()),
          "the compared step should hold collisions and arrivals")
    print(json.dumps({"card_vs_cpu": {"envs": E, "distinct_cases": E, "max_abs_err": worst,
                                      "discrete_equal": True}}), flush=True)


def mid_episode(name, steps):
    """``name``'s path on the card and ``steps`` auto-reset steps into its
    loop at its full width, each env started on its own pool case; the
    states, their CPU copy, the path's CPU copy and the count of distinct
    pool cases the envs are on."""
    from gym_collision_avoidance_torch.harness import paths

    path = serving_path(name)
    state, cases = paths.mid_episode_states(path, path.num_envs, steps, DEVICE)
    return path, state, path.to("cpu"), state.to("cpu"), cases


def argmax_agreement(name, want, got, eps, same=None):
    """The argmax of ``want`` (CPU) and ``got`` (card), ``[N, K]`` scores:
    equal on at least 99.99% of rows, and every mismatch where the CPU's
    top two differ by less than ``eps``.  ``same`` (``[N, K, K]`` bool,
    optional) marks pairs of choices that are the same action; a row whose
    two argmaxes are such a pair agrees.  Returns the ``[N]`` agreement and
    the numbers to print."""
    idx_cpu, idx_card = want.argmax(-1), got.argmax(-1)
    differ = idx_cpu != idx_card
    out = {}
    if same is not None:
        rows = torch.arange(len(idx_cpu))
        twin = differ & same[rows, idx_cpu, idx_card]
        out["index_mismatches_on_the_same_action"] = int(twin.sum())
        differ = differ & ~twin
    top2 = torch.topk(want, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1])[differ]
    check(float(differ.double().mean()) <= 1e-4,
          f"{name}: {int(differ.sum())} of {differ.numel()} action indices differ")
    largest = float(margin.max()) if len(margin) else None
    check(largest is None or largest < eps, f"{name}: a mismatch with a CPU margin of {largest}")
    return ~differ, {"agents": differ.numel(), "action_index_mismatches": int(differ.sum()),
                     **out, "largest_mismatch_margin": largest}


def orca_agreement(state, cfg, cpu_state, params=None):
    """ORCA velocities of the card and the CPU on the same states, within
    rtol 1e-4 / atol 1e-5; the ``[E, A]`` LP-branch agreement and the
    numbers to print."""
    from gym_collision_avoidance_torch.ops import orca
    from gym_collision_avoidance_torch.policies import rvo

    vel, branch = orca.orca_solve(*rvo.orca_inputs(state, cfg, params))
    want_vel, want_branch = orca.orca_solve(*rvo.orca_inputs(cpu_state, cfg, params))
    vel, branch = vel.cpu(), branch.cpu()
    check(torch.allclose(vel, want_vel, rtol=1e-4, atol=1e-5),
          f"ORCA velocities differ by up to {max_abs_err(vel, want_vel)}")
    A = vel.shape[-2]
    return branch == want_branch, {
        "max_velocity_diff": max_abs_err(vel, want_vel),
        "velocities_bitwise_equal": bitwise_equal(vel, want_vel),
        "lp_branch_differs": int((branch != want_branch).sum()),
        "agents_in_lp3": int((want_branch < A - 1).sum())}


def compare_ga3c4():
    """ga3c4 (E = 4096): GA3C action indices and the step."""
    from gym_collision_avoidance_torch.policies import ga3c

    path, state, cpu_path, cpu_state, cases = mid_episode("ga3c4", 15)
    E, A = state.pos.shape[:2]
    want = ga3c.ga3c_cadrl_probs(cpu_state, cpu_path.params)
    got = ga3c.ga3c_cadrl_probs(state, path.params).cpu()
    agree, line = argmax_agreement("GA3C", want, got, 1e-5)
    cpu, card = cpu_path.step(cpu_state), path.step(state)
    torch.cuda.synchronize()
    return {"envs": E, "distinct_cases": cases, **line,
            "max_prob_diff": float((got - want).abs().max()),
            **held_with_frame_slack("ga3c4", cpu, card, agree.reshape(E, A).all(dim=-1))}


def compare_orca4():
    """orca4 (E = 16384): ORCA velocities, LP branches, the step and the
    solve's times."""
    path, state, cpu_path, cpu_state, cases = mid_episode("orca4", 12)
    agree, line = orca_agreement(state, path.cfg, cpu_state)
    cpu, card = cpu_path.step(cpu_state), path.step(state)
    torch.cuda.synchronize()
    return {"envs": path.num_envs, "distinct_cases": cases, **line,
            **held_with_frame_slack("orca4", cpu, card, agree.all(dim=-1)),
            **orca_times(state, path.cfg)}


def compare_cadrl4():
    """cadrl4's configuration (E = 4096, one case per env): SA-CADRL's
    candidate values and action indices, and the step.  A candidate whose
    encoded heading (relative to its goal) lies within 1e-4 of +-pi is not
    held to the value tolerance: the reference's wrap puts it at either end
    of the range by an ulp, and the net reads +pi and -pi apart; those
    candidates are counted.  Two argmaxes that pick the same action (speed
    and heading within 1e-6, as candidates 0 and 1 are for an agent heading
    straight to its goal at its preferred speed) agree, and are counted."""
    from gym_collision_avoidance_torch.models.cadrl import forward_raw
    from gym_collision_avoidance_torch.policies import cadrl

    path, state, cpu_path, cpu_state, cases = mid_episode("cadrl4", 15)
    E, A = state.pos.shape[:2]
    cfg = path.cfg
    nn_cpu, aux_cpu = cadrl._cadrl_prepare(cpu_state, cfg)
    nn_card, aux_card = cadrl._cadrl_prepare(state, cfg)
    want = cadrl._cadrl_values(aux_cpu, forward_raw(cpu_path.params["cadrl"], nn_cpu))
    got = cadrl._cadrl_values(aux_card, forward_raw(path.params["cadrl"], nn_card)).cpu()
    at_wrap = nn_cpu[..., 3].abs() > math.pi - 1e-4
    value_diff = max_abs_err(got[~at_wrap], want[~at_wrap])
    check(value_diff <= 1e-4, f"SA-CADRL: candidate values differ by up to {value_diff}")
    # candidates that are one action: "keep going" (0) is "straight to the
    # goal at the preferred speed" (1) for an agent already doing that
    speed, heading = aux_cpu["action_speed"], aux_cpu["action_heading"]
    dh = torch.remainder(heading[..., :, None] - heading[..., None, :] + math.pi,
                         2 * math.pi) - math.pi
    same = ((speed[..., :, None] - speed[..., None, :]).abs() < 1e-6) & (dh.abs() < 1e-6)
    agree, line = argmax_agreement("SA-CADRL", want.flatten(0, 1), got.flatten(0, 1), 1e-5,
                                   same.flatten(0, 1))
    cpu, card = cpu_path.step(cpu_state), path.step(state)
    torch.cuda.synchronize()
    return {"envs": E, "distinct_cases": cases, **line, "max_value_diff": value_diff,
            "candidates": want.numel(), "candidates_at_heading_wrap": int(at_wrap.sum()),
            "max_value_diff_at_heading_wrap": max_abs_err(got[at_wrap], want[at_wrap]),
            **held_with_frame_slack("cadrl4", cpu, card, agree.reshape(E, A).all(dim=-1))}


def compare_drl2():
    """drl2's configuration (E = 4096, one case per env): K2 bitwise against
    its plain version on the card at the step's full width, DRL-Long's
    actions, its RVO agent's ORCA velocities, and the step on the first
    ``E_DRL2_STEP`` envs (the CPU's full pass is K2's brute-force plain
    version)."""
    from gym_collision_avoidance_torch.ops import raymarch
    from gym_collision_avoidance_torch.policies import drl_long

    path, state, cpu_path, cpu_state, cases = mid_episode("drl2", 15)
    calls, outs = [], []
    with capture(raymarch, "raymarch_cuda", calls, outs):
        path.step(state)
    torch.cuda.synchronize()
    check(len(calls) == 1, f"drl2: the step launched K2 {len(calls)} times, not once")
    ref = raymarch.raymarch_plain(*calls[0])
    check(bitwise_equal(outs[0], ref), "drl2: K2 not bitwise equal to the plain version")
    hits = int((ref < raymarch.LASER_MAX_RANGE).sum())
    check(hits > 0, "drl2: no beam hit anything")
    k2 = {"k2_bitwise_equal": True, "k2_shape": list(ref.shape), "k2_beams_hit": hits}
    del calls, outs, ref
    want = drl_long.drl_long_kernel(cpu_state, path.cfg, cpu_path.params)
    got = drl_long.drl_long_kernel(state, path.cfg, path.params).cpu()
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"DRL-Long: actions differ by up to {max_abs_err(got, want)}")
    agree, line = orca_agreement(state, path.cfg, cpu_state)
    n = E_DRL2_STEP
    cpu = cpu_path.step(cpu_state.map(lambda x: x[:n]))
    card = path.step(state.map(lambda x: x[:n]))
    torch.cuda.synchronize()
    return {"envs": path.num_envs, "distinct_cases": cases, **k2,
            "max_action_diff": max_abs_err(got, want),
            **line, **held_with_frame_slack("drl2", cpu, card, agree[:n].all(dim=-1))}


def phase_policy_card_vs_cpu():
    """One env_step of ga3c4 (E = 4096), orca4 (E = 16384), cadrl4 (E = 4096)
    and drl2 (E = 4096) on the card and on the CPU from the same mid-episode
    float32 states, each env started on its own pool case.

    GA3C and SA-CADRL: the action indices agree on at least 99.99% of
    agents (for SA-CADRL, indices of candidates that are the same action
    agree), and every mismatch sits where the CPU's top two probs (GA3C) or
    candidate values (SA-CADRL) differ by less than 1e-5 (cuBLAS sums in
    another order than the CPU, and the transcendentals differ by ulps);
    SA-CADRL's candidate values within atol 1e-4 away from the +-pi wrap of
    the encoded heading (:func:`compare_cadrl4`).  DRL-Long: the actions
    within rtol 1e-5 / atol 1e-5 (cuDNN against oneDNN).  ORCA: velocities
    within rtol 1e-4 / atol 1e-5, and whether they are bitwise equal.  The
    step's other outputs (on drl2's first 64 envs) are held as
    ``phase_card_vs_cpu`` holds them, on the envs whose agents all agree on
    their action index or LP branch, with the slack of
    :func:`goal_frame_slack` on the outputs in an agent's goal frame."""
    result = {"ga3c4": compare_ga3c4(), "orca4": compare_orca4(),
              "cadrl4": compare_cadrl4(), "drl2": compare_drl2()}
    print(json.dumps({"policy_card_vs_cpu": result}), flush=True)


def phase_networks():
    """Device time of SA-CADRL's value net on cadrl4's ``[E, A, 47, 31]``
    batch and of DRL-Long's CNN on drl2's 8192 rows (CUDA graphs of the
    calls, TF32 off) beside their float32 FLOP bounds at 67 TFLOP/s: the
    products' multiply-adds, 2 FLOP each."""
    from gym_collision_avoidance_torch.models import cadrl, drl_long

    cadrl4, drl2 = serving_path("cadrl4"), serving_path("drl2")
    rng = np.random.RandomState(3)
    net = cadrl4.params["cadrl"]
    x = torch.as_tensor(rng.randn(cadrl4.num_envs, len(cadrl4.policy_id), 47, 31),
                        dtype=torch.float32, device=DEVICE)
    rows = x.numel() // 31
    flop = 2.0 * rows * sum(w.numel() for w in (net.W0, net.W1, net.W3, net.W4))
    with torch.no_grad():
        value_ms = graph_ms(lambda: cadrl.forward_raw(net, x), inner=3)
    cnn = drl2.params["drl_long"]
    B = drl2.num_envs * len(drl2.policy_id)
    scan = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 3, 512)), dtype=torch.float32,
                           device=DEVICE)
    goal = torch.as_tensor(rng.uniform(-4, 4, (B, 2)), dtype=torch.float32, device=DEVICE)
    speed = torch.as_tensor(rng.uniform(-1, 1, (B, 2)), dtype=torch.float32, device=DEVICE)
    L1, L2 = 255, 128
    macs = (32 * L1 * 3 * 5 + 32 * L2 * 32 * 3 + cnn.fc1.weight.numel() + cnn.fc2.weight.numel()
            + 2 * 128)
    with torch.no_grad():
        cnn_ms = graph_ms(lambda: drl_long.forward(cnn, scan, goal, speed), inner=5)
    out = {"cadrl_value_net": {"rows": rows, "gflop": flop / 1e9, "ms": value_ms,
                               "bound_ms": flop / F32_FLOPS * 1e3},
           "drl_long_cnn": {"rows": B, "gflop": 2.0 * macs * B / 1e9, "ms": cnn_ms,
                            "bound_ms": 2.0 * macs * B / F32_FLOPS * 1e3}}
    print(json.dumps({"networks": out}), flush=True)


# SA-CADRL's value-net kernel: the rows of a cadrl4.serve16k step
# (E = 16384 envs x 4 agents x 47 candidates) and of the cadrl4 path's
# (E = 4096), where it gives the plain version's bits (it sums in cuBLAS's
# order); elsewhere float32 may differ by a few roundings
VALUE_ROWS = (16384 * 4 * 47, 4096 * 4 * 47)
VALUE_ATOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def phase_cadrl_value():
    """Hold ``csrc/cadrl_value.cu`` against the plain version on the card
    (float32 at tile edges, and bitwise at VALUE_ROWS; float64 at tile
    edges), equal rows giving the same bits wherever they sit; time it and the plain
    version (CUDA-graph replay) at VALUE_ROWS beside its operations bound,
    102 500 a row at 67 TFLOP/s, and its bytes bound, 32 float32s a row."""
    from gym_collision_avoidance_torch.models import cadrl
    from gym_collision_avoidance_torch.ops import cadrl_value

    worst = 0.0
    # tiles are 128 rows in float32 and 32 in float64
    cases = [(torch.float32, r) for r in (1, 127, 128, 129, 257, *VALUE_ROWS)]
    cases += [(torch.float64, r) for r in (1, 31, 32, 33, 4096)]
    rng = np.random.RandomState(11)
    for dtype, rows in cases:
        net = cadrl.load_params(dtype=dtype, device=DEVICE)
        x = torch.as_tensor(rng.randn(rows, 31) * net.std_vec.cpu().double().numpy()
                            + net.avg_vec.cpu().double().numpy(), dtype=dtype, device=DEVICE)
        before = cadrl_value.LAUNCHES
        got = cadrl.forward_raw(net, x)
        torch.cuda.synchronize()
        check(cadrl_value.LAUNCHES == before + 1, "cadrl_value: one launch")
        want = cadrl.forward_raw_plain(net, x)
        err = max_abs_err(got, want)
        check(err <= VALUE_ATOL[dtype], f"cadrl_value {dtype} R={rows}: differs by {err}")
        if dtype == torch.float32 and rows in VALUE_ROWS:
            check(bitwise_equal(got, want), f"cadrl_value R={rows}: not the plain version's bits")
        if dtype == torch.float32:
            worst = max(worst, err)
        if rows > 64:
            x[::37] = x[5].clone()
            got = cadrl.forward_raw(net, x)
            check(bool((got[::37] == got[5]).all()), f"cadrl_value R={rows}: equal rows differ")
        print(f"cadrl_value {str(dtype)[6:]} R={rows}: within {err:.3g} of the plain version",
              flush=True)
        del x, got, want
    net = cadrl.load_params(device=DEVICE)
    shapes = []
    for rows in VALUE_ROWS:
        x = torch.as_tensor(rng.randn(rows, 31), dtype=torch.float32, device=DEVICE)
        ms = graph_ms(lambda: cadrl_value.value_net_cuda(net, x), inner=5)
        plain_ms = graph_ms(lambda: cadrl.forward_raw_plain(net, x), inner=1)
        t_ops = rows * 102_500 / F32_FLOPS * 1e3
        t_bytes = rows * 32 * 4 / HBM_BYTES_PER_S * 1e3
        shapes.append({"rows": rows, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "roofline_pct": 100.0 * max(t_ops, t_bytes) / ms})
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"kernel": "cadrl_value", "library_ms": None, "by_shape": shapes}),
          flush=True)
    main = shapes[0]
    return {"name": "cadrl_value", "route": "cuda",
            "source": "gym_collision_avoidance_torch/csrc/cadrl_value.cu",
            "replaces": None, "entry": "forward_raw (cadrl4.serve16k's rows a step)",
            "launches": None, "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "by_shape": shapes}


# ---------------------------------------------------------------- laser path

@contextlib.contextmanager
def capture(module, name, calls, outs=None, limit=None):
    """Record the arguments of every call of ``module.name`` in ``calls``,
    and its results in ``outs`` if given; of the first ``limit`` calls only,
    if given."""
    orig = getattr(module, name)

    def spy(*args):
        out = orig(*args)
        if limit is None or len(calls) < limit:
            calls.append(args)
            if outs is not None:
                outs.append(out)
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def bitwise_equal(a, b):
    itype = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(itype),
                                                                     b.view(itype))


def laser_states(cfg, E, seed, device, A=A_LASER, odd=False):
    """Seeded states of the circle scenario shrunk to a random radius in
    [0.8, 8] m and turned by a random angle per env, with jitter and random
    headings, so that beams meet discs at every range."""
    from gym_collision_avoidance_torch import init_state

    rng = np.random.RandomState(seed)
    ang = 2 * np.pi * np.arange(A) / A
    unit = np.stack([np.cos(ang), np.sin(ang)], -1)
    scale = rng.uniform(0.8, 8.0, (E, 1, 1))
    turn = rng.uniform(0, 2 * np.pi, (E, 1))
    rot = np.stack([np.cos(turn), -np.sin(turn), np.sin(turn), np.cos(turn)], -1).reshape(E, 1, 2, 2)
    pos = scale * np.einsum("eaij,aj->eai", np.broadcast_to(rot, (E, A, 2, 2)), unit)
    pos = pos + rng.uniform(-0.2, 0.2, pos.shape)
    valid = np.ones((E, A), bool)
    if odd:                       # invalid agents and agents off the map
        valid = rng.rand(E, A) > 0.2
        pos[::2, 0] = [cfg.map_x_width / 2 + 0.7, 0.0]
        pos[1::3, 1] = [0.0, -cfg.map_y_width / 2 - 0.4]
    return init_state(cfg, pos, -pos, np.full((E, A), 0.3), np.ones((E, A)),
                      heading=rng.uniform(-np.pi, np.pi, (E, A)), valid=valid, device=device)


def band_model(kernel):
    """``tests/test_torch_{kernel}_band.py``: the plain PyTorch model of K2's
    (``raymarch``) or K3's (``laser_fused``) band design, its seeded edge
    cases and its work count (it imports no JAX)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"test_torch_{kernel}_band.py")
    spec = importlib.util.spec_from_file_location(f"{kernel}_band", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k2_bound(args, out, band):
    """Least device time of one K2 launch, from this run's data: the bytes
    read and written once, and the operations the band design needs (each
    warp of 32 beams screens every usable source against its wedge, about
    15 operations; each beam screens the sources its warp keeps, about 20,
    and tests the band samples of the crossing ones up to its second hit,
    about 25 each); whichever is larger.  Also the old brute-force count:
    every sample up to the second hit against every disc and static cell."""
    from gym_collision_avoidance_torch.ops import raymarch

    moved = sum(t.numel() * t.element_size() for t in args if torch.is_tensor(t))
    moved += out.numel() * out.element_size()
    warp_screens, lane_screens, samples = band.band_work(args, out)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = (15 * warp_screens + 20 * lane_screens + 25 * samples) / F32_FLOPS
    R = raymarch.LASER_NUM_RANGE_SAMPLES
    ans = torch.round(out.double() / raymarch.LASER_RANGE_RESOLUTION).long()
    second = (out < raymarch.LASER_MAX_RANGE) & (ans < R - 1)
    marched = float(torch.where(second, ans + 2, R).sum())
    A, S = args[6].shape[-1], args[9].shape[0]
    # per sample: position, cell and map test ~20, host disc 7, each disc 7,
    # each static cell 2
    t_brute = marched * (27 + 7 * A + 2 * S) / F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_bytes": t_bytes * 1e3, "bound_ms_bruteforce": max(t_bytes, t_brute) * 1e3,
            "warp_screens_per_beam": warp_screens / out.numel(),
            "lane_screens_per_beam": lane_screens / out.numel(),
            "band_samples_per_beam": samples / out.numel()}


# DRL-Long's convolution kernel: a drl_long4.serve16k step's rows (E = 16384
# envs x 4 agents) at 512 beams, where it gives cuDNN's bits in float32 (it
# sums in that kernel's order); elsewhere float32 may differ by a few roundings
CONV_ROWS, CONV_L = 16384 * 4, 512
CONV_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def phase_drl_long_conv():
    """Hold ``csrc/drl_long_conv.cu`` against the plain version (the net's
    ``nn.Conv1d`` + ReLU chain, cuDNN) on the card, float32 and float64, at
    ragged row counts and scan lengths, the first and last output positions
    (conv2's zero padding) apart, bitwise in float32 at CONV_L; time it and
    the plain version (CUDA-graph replays) at ``[CONV_ROWS, 3, CONV_L]``
    beside its operations bound, 1 031 232 a row at 67 TFLOP/s, and its
    bytes bound, the scans in and the ``[B, 32, 128]`` output out."""
    from gym_collision_avoidance_torch.models import drl_long
    from gym_collision_avoidance_torch.ops import drl_long_conv as conv

    rng = np.random.RandomState(23)
    worst = 0.0
    cases = [(torch.float32, B, L) for B in (1, 7, 8195, CONV_ROWS) for L in (512, 515)]
    cases += [(torch.float32, 5, L) for L in (3, 5, 37, 64, 129, 260)]
    cases += [(torch.float64, B, L) for B in (1, 7, 8195) for L in (512, 37)]
    nets = {}
    for dtype, B, L in cases:
        net = nets.get((dtype, L))
        if net is None:
            net = nets[(dtype, L)] = drl_long.init_params(L, seed=L, dtype=dtype, device=DEVICE)
            with torch.no_grad():
                net.conv1.bias.uniform_(0.05, 0.3)    # relu(b1) > 0 where the pad must read 0
        x = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 3, L)), dtype=dtype, device=DEVICE)
        before = conv.LAUNCHES
        got = conv.drl_long_conv_cuda(net, x)
        torch.cuda.synchronize()
        check(conv.LAUNCHES == before + 1, "drl_long_conv: one launch")
        want = conv.drl_long_conv_plain(net, x)
        check(got.shape == want.shape == (B, 32, conv.out_len(L)),
              f"drl_long_conv B={B} L={L}: shape {tuple(got.shape)}")
        err = max_abs_err(got, want)
        ends = max(max_abs_err(got[..., 0], want[..., 0]),
                   max_abs_err(got[..., -1], want[..., -1]))
        check(err <= CONV_TOL[dtype], f"drl_long_conv {dtype} B={B} L={L}: differs by {err}")
        if dtype == torch.float32 and L == CONV_L:
            check(bitwise_equal(got, want), f"drl_long_conv B={B}: not the plain version's bits")
        if dtype == torch.float32:
            worst = max(worst, err)
        print(f"drl_long_conv {str(dtype)[6:]} B={B} L={L}: within {err:.3g} of the plain "
              f"version ({ends:.3g} at positions 0 and L2 - 1)", flush=True)
        del x, got, want
    nets.clear()
    torch.cuda.empty_cache()
    net = drl_long.load_params(device=DEVICE)
    x = torch.as_tensor(rng.uniform(-0.5, 0.5, (CONV_ROWS, 3, CONV_L)), dtype=torch.float32,
                        device=DEVICE)
    ms = graph_ms(lambda: conv.drl_long_conv_cuda(net, x), inner=5)
    plain_ms = graph_ms(lambda: conv.drl_long_conv_plain(net, x), inner=1)
    L2 = conv.out_len(CONV_L)
    L1 = (CONV_L - 3) // 2 + 1
    ops_row = 2 * (32 * L1 * 3 * 5 + 32 * L2 * 32 * 3)
    t_ops = CONV_ROWS * ops_row / F32_FLOPS * 1e3
    t_bytes = CONV_ROWS * (3 * CONV_L + 32 * L2) * 4 / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    line = {"rows": CONV_ROWS, "L": CONV_L, "ops_per_row": ops_row, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "roofline_pct": 100.0 * bound / ms, "max_abs_err": worst}
    print(json.dumps({"kernel": "drl_long_conv", "device": nvidia_smi_line(), **line}),
          flush=True)
    del x
    torch.cuda.empty_cache()
    # the plain version is cuDNN's convolutions with their bias adds and
    # ReLUs: the library chain the port no longer calls on this path
    return {"name": "drl_long_conv", "route": "cuda",
            "source": "gym_collision_avoidance_torch/csrc/drl_long_conv.cu",
            "replaces": None, "entry": "DRLLongNet.trunk (drl_long4.serve16k's rows a step)",
            "launches": None, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": line["bound_by"], "library_ms": plain_ms}


def phase_k2():
    """K2 against its plain version, bitwise, on the card: the laser path's
    cases and the band model's edge cases, in float32 and float64; timed at
    the laser path's full width on the empty map and on map 002."""
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.obs import sensors
    from gym_collision_avoidance_torch.ops import raymarch

    band = band_model("raymarch")

    def held(name, c, state, cells):
        calls = []
        with capture(raymarch, "raymarch_cuda", calls):
            out = sensors.laserscan_sparse(state, c, cells)
        torch.cuda.synchronize()
        check(len(calls) == 1, f"K2 {name}: the full pass did not launch K2")
        ref = raymarch.raymarch_plain(*calls[0])
        check(bitwise_equal(out, ref), f"K2 {name}: not bitwise equal to the plain version")
        hits = int((ref < raymarch.LASER_MAX_RANGE).sum())
        check(hits > 0, f"K2 {name}: no beam hit anything")
        print(f"K2 {name} (E={state.pos.shape[0]}, A={state.pos.shape[1]}): bitwise equal, "
              f"{hits} of {ref.numel()} beams hit", flush=True)
        return calls[0], out, max_abs_err(out, ref)

    cfg = paths.laser_config(False)
    cases = [("f32 full width, empty map", cfg, E_LASER, None, False),
             ("f32, map 002 (84 cells + 16 padding rows)", cfg, 32, "002", False),
             ("f64", paths.laser_config(False, "float64"), 8, None, False),
             ("f32, E*A = 35, invalid and off-map agents", cfg, 7, "002", True),
             ("f64, map 002", paths.laser_config(False, "float64"), 8, "002", False)]
    worst, timed = 0.0, {}
    for i, (name, c, E, map_name, odd) in enumerate(cases):
        _static, cells = paths.map_inputs(c, DEVICE, map_name, pad=16 if map_name else 0)
        state = laser_states(c, E, 10 + i, DEVICE, A=5 if odd else A_LASER, odd=odd)
        args, out, err = held(name, c, state, cells)
        worst = max(worst, err)
        timed.setdefault("empty", (args, out))
    for name in band.CASES:
        for dtype in ("float32", "float64"):
            c, state, cells = band.build_case(name, dtype, DEVICE)
            worst = max(worst, held(f"{dtype[5:]}-bit band case {name}", c, state, cells)[2])
    # full width on map 002, for the per-source screen's share
    _static, cells = paths.map_inputs(cfg, DEVICE, "002", pad=16)
    args, out, _err = held("f32 full width, map 002", cfg,
                           laser_states(cfg, E_LASER, 15, DEVICE), cells)
    timed["map_002"] = (args, out)

    res = {}
    for key, (args, out) in timed.items():
        res[key] = {"ms": graph_ms(lambda: raymarch.raymarch_cuda(*args), inner=5),
                    **k2_bound(args, out, band)}
    args = timed["empty"][0]
    plain_ms = graph_ms(lambda: raymarch.raymarch_plain(*args), inner=2)
    empty = res["empty"]
    print(json.dumps({"kernel": "raymarch", "plain_ms": plain_ms, "library_ms": None,
                      "launches_per_step": 1, "shape": [E_LASER, A_LASER, L_LASER], **res}),
          flush=True)
    return {"name": "raymarch", "route": "cuda",
            "source": "gym_collision_avoidance_torch/csrc/raymarch.cu",
            "replaces": "gym_collision_avoidance_tpu/ops/raymarch.py:173",
            "launches": None, "max_abs_err": worst, "ms": empty["ms"], "plain_ms": plain_ms,
            "bound_ms": empty["bound_ms"], "bound_by": empty["bound_by"], "library_ms": None,
            "bound_ms_bruteforce": empty["bound_ms_bruteforce"],
            "bound_ms_bytes": empty["bound_ms_bytes"],
            "ms_map_002": res["map_002"]["ms"], "bound_ms_map_002": res["map_002"]["bound_ms"]}


def k3_bound(args, out, band):
    """Least device time of one K3 launch, from this run's data: the bytes
    read and written once, and the operations the band design needs (each
    warp of 32 beams screens the usable sources against its wedge, about 15
    operations; each beam screens those its warp keeps up to its Cs + 1-th
    crossing, about 20, and tests the band samples of its kept ones up to its
    second hit, about 25 each); whichever is larger.  Also the count of the
    definition's design: every usable source screened on every beam and
    ``Wn`` samples tested for every kept one."""
    cos_a, relx, span_ok, Wn, Cs = args[4], args[9], args[13], args[15], args[16]
    moved = sum(t.numel() * t.element_size() for t in args if torch.is_tensor(t))
    moved += cos_a.numel() * (cos_a.element_size() + 1)            # ranges + flags
    warp_screens, lane_screens, samples = band.band_work(args, out)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = (15 * warp_screens + 20 * lane_screens + 25 * samples) / F32_FLOPS
    cross = band.screen(args)[0]
    kept = float(torch.clamp(cross.sum(dim=3), max=Cs).sum())
    screened = float(span_ok.sum()) * cos_a.shape[-1] / relx.shape[2]
    t_window = (15 * screened + 25 * Wn * kept) / F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_bytes": t_bytes * 1e3, "bound_ms_window": max(t_bytes, t_window) * 1e3,
            "warp_screens_per_beam": warp_screens / out.numel(),
            "lane_screens_per_beam": lane_screens / out.numel(),
            "band_samples_per_beam": samples / out.numel()}


def phase_k3():
    """K3 against its plain version, bitwise (ranges and overflow flags), on
    the card: the fast route's cases and the band model's edge cases, in
    float32 and float64; timed at the fast route's full width on the empty
    map, on map 002 and on the route without wedge culling (B = 1)."""
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.obs import sensors
    from gym_collision_avoidance_torch.ops import laser_fused

    band = band_model("laser_fused")

    def held(name, c, state, cells):
        calls = []
        with capture(laser_fused, "beam_compacted_cuda", calls):
            sensors.laserscan_sparse(state, c, cells, return_overflow=True)
        torch.cuda.synchronize()
        check(len(calls) == 1, f"K3 {name}: the fast route did not launch K3")
        out, ovf = laser_fused.beam_compacted_cuda(*calls[0])
        ref, ref_ovf = laser_fused.beam_compacted_plain(*calls[0])
        torch.cuda.synchronize()
        check(bitwise_equal(out, ref), f"K3 {name}: ranges not bitwise equal")
        check(torch.equal(ovf, ref_ovf), f"K3 {name}: overflow flags differ")
        hits = int((ref < laser_fused.LASER_MAX_RANGE).sum())
        check(hits > 0, f"K3 {name}: no beam hit anything")
        print(f"K3 {name} (E={state.pos.shape[0]}, B={calls[0][6].shape[2]}, "
              f"S={calls[0][6].shape[3]}): bitwise equal, {hits} of {ref.numel()} beams hit, "
              f"{int(ref_ovf.sum())} beams overflow their slots", flush=True)
        return calls[0], out, max_abs_err(out, ref), int(ref_ovf.sum())

    cfg = paths.laser_config(True)
    cases = [("f32 full width, empty map", cfg, E_LASER, None, False),
             ("f32, Cs = 1 (slots overflow)", paths.laser_config(True, laserscan_beam_slots=1),
              32, None, False),
             ("f32, map 002 cells", cfg, 32, "002", False),
             ("f64", paths.laser_config(True, "float64"), 8, None, False),
             ("f32, invalid and off-map agents", cfg, 7, "002", True)]
    worst, timed = 0.0, {}
    for i, (name, c, E, map_name, odd) in enumerate(cases):
        _static, cells = paths.map_inputs(c, DEVICE, map_name, pad=16 if map_name else 0)
        args, out, err, overflowed = held(name, c, laser_states(c, E, 20 + i, DEVICE, odd=odd),
                                          cells)
        worst = max(worst, err)
        timed.setdefault("empty", (args, out))
        if "Cs = 1" in name:
            check(overflowed > 0, "the Cs = 1 case should overflow")
    for name in band.CASES:
        for dtype in ("float32", "float64"):
            c, state, cells = band.build_case(name, dtype, DEVICE)
            worst = max(worst, held(f"{dtype[5:]}-bit band case {name}", c, state, cells)[2])
    # full width on map 002 (9 candidates + 84 cells + 16 padding rows a
    # block), and on the route without wedge culling (B = 1, S = A)
    _static, cells = paths.map_inputs(cfg, DEVICE, "002", pad=16)
    args, out, _err, _ovf = held("f32 full width, map 002", cfg,
                                 laser_states(cfg, E_LASER, 25, DEVICE), cells)
    timed["map_002"] = (args, out)
    b1 = paths.laser_config(True, laserscan_num_candidate_discs=None)
    _static, cells = paths.map_inputs(b1, DEVICE)
    args, out, _err, _ovf = held("f32 full width, B = 1", b1,
                                 laser_states(b1, E_LASER, 26, DEVICE), cells)
    timed["b1"] = (args, out)

    res = {}
    for key, (args, out) in timed.items():
        res[key] = {"ms": graph_ms(lambda: laser_fused.beam_compacted_cuda(*args)),
                    **k3_bound(args, out, band)}
    args = timed["empty"][0]
    plain_ms = graph_ms(lambda: laser_fused.beam_compacted_plain(*args), inner=5)
    empty = res["empty"]
    print(json.dumps({"kernel": "laser_fused", "plain_ms": plain_ms, "library_ms": None,
                      "launches_per_step": 1, "shape": [E_LASER, A_LASER, L_LASER], **res}),
          flush=True)
    return {"name": "laser_fused", "route": "cuda",
            "source": "gym_collision_avoidance_torch/csrc/laser_fused.cu",
            "replaces": "gym_collision_avoidance_tpu/ops/laser_pallas.py:211",
            "launches": None, "max_abs_err": worst, "ms": empty["ms"], "plain_ms": plain_ms,
            "bound_ms": empty["bound_ms"], "bound_by": empty["bound_by"], "library_ms": None,
            "bound_ms_window": empty["bound_ms_window"],
            "bound_ms_bytes": empty["bound_ms_bytes"],
            "ms_map_002": res["map_002"]["ms"], "bound_ms_map_002": res["map_002"]["bound_ms"],
            "ms_b1": res["b1"]["ms"], "bound_ms_b1": res["b1"]["bound_ms"]}


def phase_fast_vs_full(states):
    """Continue the full pass's trajectory for 64 steps; on every 8th step's
    states the fast route's ranges equal the full pass's bitwise wherever
    its guard is quiet."""
    from gym_collision_avoidance_torch.env import autoreset
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.obs import sensors

    path = serving_path("laser_full")
    full, fast, cells = path.cfg, paths.laser_config(True), path.static_cells
    step = autoreset.make_autoreset_step(full, path.pool, path.policy_id, path.active,
                                         params=path.params, device=DEVICE, **path.world)
    counter = torch.arange(E_LASER, dtype=torch.int32, device=DEVICE)
    tripped = compared = beams = 0
    for t in range(1, 65):
        states, counter = step(states, counter)[:2]
        if t % 8:
            continue
        want = sensors.laserscan_sparse(states, full, cells)
        got, ovf = sensors.laserscan_sparse(states, fast, cells, return_overflow=True)
        quiet = ~ovf
        check(bitwise_equal(got[quiet], want[quiet]),
              f"step {t}: the fast route differs from the full pass where its guard is quiet")
        tripped += int(ovf.sum())
        compared += int(quiet.sum())
        beams += int((want[quiet] < 6.0).sum())
    check(compared > 0, "the guard tripped on every env state")
    print(json.dumps({"fast_vs_full": {
        "env_states": 8 * E_LASER, "guard_tripped": tripped, "compared_bitwise": compared,
        "beams_hitting_in_compared": beams}}), flush=True)


def phase_laser_card_vs_cpu():
    """One laser env_step (map 002, E = 16) on the card and on the CPU from
    the same states, held by :func:`compare_steps`: discrete outputs equal,
    floats to rtol 1e-5 / atol 1e-6, laserscan ranges equal on at least
    99.99% of the entries (float32 sin/cos differ by ulps between the
    devices)."""
    from gym_collision_avoidance_torch import env_step
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.policies import registry

    E = 16
    obs_keys = ("dist_to_goal", "radius", "other_agents_states", "laserscan")
    result = {}
    for fast in (False, True):
        cfg = paths.laser_config(fast)
        static, cells = paths.map_inputs(cfg, DEVICE, "002")

        def step(state, static=static, cells=cells):
            return env_step(state, None, cfg, None, (registry.NONCOOP,), paths.LASER_SENSORS,
                            obs_keys, static.to(state.pos.device), cells.to(state.pos.device))

        state = laser_states(cfg, E, 31, "cpu")
        for _ in range(3):
            state = step(state)[0]
        cpu, card = step(state), step(state.to(DEVICE))
        torch.cuda.synchronize()
        name = "laser_card_vs_cpu_" + ("fast" if fast else "full")
        worst, _, laser_diff, laser_n = compare_steps(name, cpu, card, 1e-5, 1e-6)
        check(bool(cpu[0].in_collision.any()), "the compared step should hold collisions")
        result["fast" if fast else "full"] = {
            "envs": E, "max_abs_err": worst, "laser_entries_differing": laser_diff,
            "laser_entries": laser_n, "wall_or_agent_collisions": int(cpu[0].in_collision.sum()),
            "discrete_equal": True}
    print(json.dumps({"laser_card_vs_cpu": result}), flush=True)


# ------------------------------------------------------------ training


def finite_metrics(name, metrics):
    values = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in values.values()), f"{name}: non-finite metric {values}")
    check(values["episodes_finished"] > 0, f"{name}: no episode finished in an iteration")
    return values


def phase_training(name, kernels, profiler):
    """Train ``name``'s recipe at its width: one warm-up iteration, the
    counts to 0, ``TRAIN_ITERS[name]`` timed iterations (each phase ends in
    a synchronise), then one traced iteration.  K1 must launch once per
    rollout step, K2 once per step on train_drl2 and never elsewhere, K3
    never.  Returns the launch counts and the trained net."""
    from gym_collision_avoidance_torch.harness import paths

    path = paths.training_path(name)
    trainer = path.trainer(DEVICE)
    carry = path.init(trainer)
    gen = torch.Generator(DEVICE).manual_seed(7)
    *carry, _ = trainer.train_step(*carry, rng=gen)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.LAUNCHES = 0
    iters, T, E = TRAIN_ITERS[name], path.ppo.horizon, path.ppo.num_envs
    timings, metrics = {}, []
    t0 = time.perf_counter()
    for _ in range(iters):
        *carry, m = trainer.train_step(*carry, rng=gen, timings=timings)
        metrics.append(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: k.LAUNCHES for n, k in kernels.items()}
    check(launches["pairwise"] == iters * T,
          f"{name}: K1 launched {launches['pairwise']} times in {iters * T} rollout steps")
    want_k2 = iters * T if name == "train_drl2" else 0
    check(launches["raymarch"] == want_k2,
          f"{name}: K2 launched {launches['raymarch']} times, not {want_k2}")
    check(launches["laser_fused"] == 0, f"{name}: K3 launched")
    values = [finite_metrics(name, m) for m in metrics]
    for k, p in carry[0].named_parameters():
        check(bool(torch.isfinite(p).all()), f"{name}: non-finite parameter {k}")
    traced, carry = profiler.trace_iteration(trainer, carry, gen)
    line = {"num_envs": E, "horizon": T, "agents": path.ppo.num_agents,
            "arch": path.ppo.policy_arch, "minibatch_rows": path.ppo.mb_envs * T,
            "iterations": iters, "seconds": seconds, "ms_per_iteration": 1e3 * seconds / iters,
            **{f"{k}_ms_per_iteration": 1e3 * v / iters for k, v in timings.items()},
            "env_steps_per_s": iters * E * T / seconds,
            "launches": launches, "k1_launches_per_iteration": launches["pairwise"] / iters,
            "k2_launches_per_iteration": launches["raymarch"] / iters,
            "kernels_per_iteration": traced["kernels_per_iteration"],
            "traced": {k: traced[k] for k in ("wall_ms_per_iteration",
                                              "device_busy_ms_per_iteration",
                                              "device_idle_share", "phases")},
            "metrics": values}
    print(json.dumps({name: line}), flush=True)
    return launches, carry[0]


def state_to(carry, device):
    """``(states, counters, obs)`` copied to ``device``."""
    states, counters, obs = carry
    return (states.map(lambda x: x.to(device)), counters.to(device),
            {k: v.to(device) for k, v in obs.items()})


def compare_sample(name, t, want, got, params, trainer, noise_t):
    """One rollout step's sample on the card against the CPU's, from the
    same inputs: GA3C's action indices equal off near-ties (the CPU's
    ``logits + g`` at the two indices within 1e-5; such an env is left out
    of this step's other outputs), ``done``, ``game_over`` and ``alive``
    equal, the floats to ROLL_TOL.  GA3C's log-probs are log-softmaxes of
    logits that a trained net puts far from 0, so their rounding is
    absolute in the logits' scale: they take rtol times each row's largest
    |logit| as well.  Returns the near-tie gaps and the largest float
    differences."""
    got = {k: v.cpu() for k, v in got.items()}
    L = len(want["done"]) // len(want["game_over"])
    stream_ok = torch.ones(len(want["done"]), dtype=torch.bool)
    gaps, scale = [], {}
    if want["act"].shape[-1] == 1:                        # GA3C's action indices
        with torch.no_grad():
            (logits,), _ = trainer.family.net_apply(params, want["x"])
        scale["logp"] = ROLL_TOL["rtol"] * logits.abs().amax(dim=-1)
        differ = (got["act"] != want["act"])[:, 0]
        if bool(differ.any()):
            score = logits[differ] + noise_t[differ]
            rows = torch.arange(len(score))
            gaps = (score[rows, want["act"][differ, 0].long()]
                    - score[rows, got["act"][differ, 0].long()]).abs().tolist()
        check(all(g < 1e-5 for g in gaps),
              f"{name}: step {t}: action indices differ off a near-tie: {gaps}")
        env_ok = ~differ.reshape(-1, L).any(dim=1)
        stream_ok = env_ok.repeat_interleave(L)
    else:
        env_ok = torch.ones(len(want["game_over"]), dtype=torch.bool)
    worst = {}
    for k, w in want.items():
        ok = env_ok if k == "game_over" else stream_ok
        g, w = got[k][ok], w[ok]
        if w.is_floating_point() and k != "alive":
            extra = scale[k][ok] if k in scale else 0.0
            close = (g - w).abs() <= ROLL_TOL["atol"] + ROLL_TOL["rtol"] * w.abs() + extra
            check(bool(close.all()),
                  f"{name}: step {t}: rollout {k} differs by up to {max_abs_err(g, w)}")
            worst[k] = max_abs_err(g, w)
        else:
            check(torch.equal(g, w), f"{name}: step {t}: rollout {k} differs")
    return gaps, worst


@contextlib.contextmanager
def kink_sides(sides, rows):
    """Append to ``sides``, for each kink of the loss that the enclosed code
    passes, which side each of the ``rows`` samples took: the sign of every
    ReLU input, and where the probability ratio (``maths.clip``'s one call
    with a row axis) lies against the clip range, ties apart."""
    from gym_collision_avoidance_torch.core import maths

    relu, clip = [], []
    with capture(torch, "relu", relu), capture(maths, "clip", clip):
        yield
    for (z,) in relu:
        check(z.shape[0] == rows, f"a ReLU input of shape {tuple(z.shape)} has no row axis")
        sides.append((z > 0).reshape(rows, -1).cpu())
    ratios = [(x, lo, hi) for x, lo, hi in clip if x.shape == (rows,)]
    check(len(ratios) == 1, f"{len(ratios)} clips of the ratio")
    x, lo, hi = ratios[0]
    sides.append(torch.stack([x < lo, x <= lo, x < hi, x <= hi], dim=1).cpu())


def compare_training(name):
    """The three phases of one ``train_step`` of ``name``'s recipe at
    E_TRAIN_CMP envs and T_TRAIN_CMP steps, on the card and on the CPU, each
    from the same inputs: every rollout step from the CPU's states and the
    same noise (:func:`compare_sample`; a multi-step rollout would amplify
    the devices' ulps of ``atan2`` near the goals, PERF.md), the GAE of each
    device's samples to GAE_TOL, and every ``minibatch_step`` of the update
    epochs from the CPU's weights and optimizer state.

    A sample whose ReLU input or ratio lies within rounding of a kink can
    take one side of it on the card and the other on the CPU, which moves
    its row's whole share of the gradient (:func:`kink_sides` finds them).
    Such rows are left out of the minibatch (weight 0) on both devices and
    counted; on the rest, the loss, value loss and clip fraction are held to
    METRICS_TOL and every gradient entry to GRAD_TOL.  The card's global
    norm of the CPU's gradients is held within rtol 1e-5, and the card's
    Adam step (``optim.adam``) on the CPU's clipped gradients and state
    against the CPU's update (elementwise IEEE operations: reported bitwise,
    held to rtol 1e-6 / atol lr * 1e-7).  Chained steps are not compared:
    Adam divides each gradient by its own RMS, which amplifies float32
    rounding where a trained net's gradient is mostly cancellation
    (PERF.md §6)."""
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.train import optim
    from gym_collision_avoidance_torch.train.ppo import compute_gae

    path = paths.training_path(name).resized(E_TRAIN_CMP, T_TRAIN_CMP)
    ppo = path.ppo
    cpu_tr, card_tr = path.trainer("cpu"), path.trainer(DEVICE)
    params, opt, *env = path.init(cpu_tr)
    card_params = copy.deepcopy(params).to(DEVICE)
    noise = cpu_tr.sample_noise(torch.Generator().manual_seed(3))
    key = cpu_tr.family.noise
    samples = {"cpu": [], "card": []}
    gaps, worst = [], {}
    for t in range(ppo.horizon):
        *nxt, want = cpu_tr.rollout_step(params, *env, noise[key][t])
        *_, got = card_tr.rollout_step(card_params, *state_to(env, DEVICE),
                                       noise[key][t].to(DEVICE))
        g, w = compare_sample(name, t, want, got, params, cpu_tr, noise[key][t])
        gaps += g
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in w.items()}
        samples["cpu"].append(want)
        samples["card"].append(got)
        env = nxt
    torch.cuda.synchronize()
    data = {}
    for dev, trainer, p in (("cpu", cpu_tr, params), ("card", card_tr, card_params)):
        d = {k: torch.stack([s[k] for s in samples[dev]]) for k in samples[dev][0]}
        with torch.no_grad():
            _, d["last_value"] = trainer.family.net_apply(p, trainer.flatten_ego(
                state_to(env, trainer.device)[2]))
        d["adv"], d["target"] = compute_gae(d["reward"], d["value"], d["done"],
                                            d["last_value"], ppo.gamma, ppo.gae_lambda)
        data[dev] = d
    for k in ("adv", "target"):
        got, want = data["card"][k].cpu(), data["cpu"][k]
        check(torch.allclose(got, want, **GAE_TOL),
              f"{name}: GAE {k} differs by up to {max_abs_err(got, want)}")
        worst[f"gae_{k}"] = max_abs_err(got, want)

    def card(tensors):
        return {k: v.to(DEVICE) for k, v in tensors.items()}

    d = data["cpu"]
    grad_err, stat_err, update_err, bitwise, kinks, ratio_kinks = 0.0, 0.0, 0.0, 0, [], 0
    mbs = list(cpu_tr.minibatches(d, d["adv"], d["target"], noise["perm"]))
    for m, mb in enumerate(mbs):
        rows = len(mb["adv"])
        before = copy.deepcopy(params)
        card_opt = {"count": opt["count"], "mu": card(opt["mu"]), "nu": card(opt["nu"])}
        sides = {"cpu": [], "card": []}
        with kink_sides(sides["cpu"], rows):
            want_g, want_s, want_u, next_opt = cpu_tr.minibatch_step(params, opt, mb)
        with kink_sides(sides["card"], rows):
            got_g, got_s, _, _ = card_tr.minibatch_step(copy.deepcopy(before).to(DEVICE),
                                                        card_opt, card(mb))
        crossed = [(a != b).any(dim=1) for a, b in zip(*sides.values())]
        kink = torch.stack(crossed).any(dim=0)
        kinks.append(int(kink.sum()))
        ratio_kinks += int(crossed[-1].sum())          # kink_sides puts the ratio last
        held = (want_g, want_s, got_g, got_s)
        if kinks[-1]:
            kept = dict(mb, alive=mb["alive"] * (~kink).to(mb["alive"].dtype))
            held = (*cpu_tr.gradients(copy.deepcopy(before), kept),
                    *card_tr.gradients(copy.deepcopy(before).to(DEVICE), card(kept)))
        hw_g, hw_s, hg_g, hg_s = held
        hg_s = hg_s.cpu()
        check(torch.allclose(hg_s, hw_s, **METRICS_TOL),
              f"{name}: minibatch {m}: loss, value loss, clip fraction {hg_s.tolist()} "
              f"against {hw_s.tolist()} ({kinks[-1]} rows at a kink left out)")
        stat_err = max(stat_err, max_abs_err(hg_s, hw_s))
        for k, w in hw_g.items():
            err = max_abs_err(hg_g[k], w) / max(float(w.abs().max()), 1e-30)
            check(err <= GRAD_TOL, f"{name}: minibatch {m}: gradient {k} differs by "
                  f"{err:.3g} of its largest entry ({kinks[-1]} rows at a kink left out)")
            grad_err = max(grad_err, err)
        norms = [float(optim.global_norm(g)) for g in (card(want_g), want_g)]
        check(math.isclose(*norms, rel_tol=1e-5), f"{name}: minibatch {m}: global norm "
              f"{norms[0]} against {norms[1]}")
        # optim.update is adam(clip_by_global_norm(...)): the card's Adam on
        # the very clipped gradients the CPU's step used
        clipped = optim.clip_by_global_norm(want_g, ppo.max_grad_norm)
        got_u, _ = optim.adam(card(clipped), card_opt, ppo.lr)
        for k, w in want_u.items():
            g = got_u[k].cpu()
            check(torch.allclose(g, w, rtol=1e-6, atol=ppo.lr * 1e-7),
                  f"{name}: minibatch {m}: Adam update of {k} differs by up to "
                  f"{max_abs_err(g, w)}")
            update_err = max(update_err, max_abs_err(g, w))
            bitwise += bitwise_equal(g, w)
        opt = next_opt
    torch.cuda.synchronize()
    return {"envs": ppo.num_envs, "horizon": ppo.horizon, "samples": ppo.horizon * cpu_tr.B,
            "action_index_mismatches_at_near_ties": len(gaps), "near_tie_gaps": gaps,
            "max_abs_err": worst, "minibatch_steps": len(mbs),
            "minibatch_rows": len(mbs[0]["adv"]), "rows_at_a_kink_left_out": kinks,
            "of_them_at_the_ratio_clip": ratio_kinks,
            "max_stats_diff": stat_err, "max_gradient_diff_of_largest_entry": grad_err,
            "max_adam_update_diff": update_err,
            "adam_updates_bitwise_equal": f"{bitwise} of {len(mbs) * len(opt['mu'])}"}


def phase_train_card_vs_cpu():
    result = {name: compare_training(name) for name in TRAIN_ITERS}
    print(json.dumps({"train_card_vs_cpu": result}), flush=True)


def phase_train_deterministic():
    """Two iterations of train_ga3c4 and train_drl2 from one seed, twice:
    the params and the optimizer state must be the same bits."""
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.utils import checkpoint as ckpt

    result = {}
    for name in ("train_ga3c4", "train_drl2"):
        path = paths.training_path(name)
        trainer = path.trainer(DEVICE)
        runs = []
        for _ in range(2):
            carry = path.init(trainer)
            gen = torch.Generator(DEVICE).manual_seed(11)
            for _ in range(2):
                *carry, _m = trainer.train_step(*carry, rng=gen)
            runs.append(ckpt.structure((carry[0], carry[1])))
        torch.cuda.synchronize()
        (a, rec_a), (b, rec_b) = runs
        check(rec_a == rec_b and all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"{name}: two runs from one seed differ")
        result[name] = {"iterations": 2, "leaves": len(a), "bitwise_equal": True}
    print(json.dumps({"train_deterministic": result}), flush=True)


def phase_kernels_on_training():
    """K1 on the first TRAIN_CHECK_STEPS rollout steps of every training
    path, at its own envs and agents, and K2 on train_drl2's (512 beams, an
    empty static-cell list): each launch's arguments captured and its
    outputs held bitwise against the plain version on them."""
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.ops import pairwise, raymarch

    result = {}
    for name in TRAIN_ITERS:
        full = paths.training_path(name)
        path = full.resized(full.ppo.num_envs, TRAIN_CHECK_STEPS)
        trainer = path.trainer(DEVICE)
        params, _, states, counters, obs = path.init(trainer)
        noise = trainer.sample_noise(torch.Generator(DEVICE).manual_seed(5))
        k1_calls, k1_outs, k2_calls, k2_outs = [], [], [], []
        with capture(pairwise, "pairwise_rewards_cuda", k1_calls, k1_outs), \
                capture(raymarch, "raymarch_cuda", k2_calls, k2_outs):
            trainer.rollout(params, states, counters, obs, noise)
        torch.cuda.synchronize()
        check(len(k1_calls) == TRAIN_CHECK_STEPS,
              f"{name}: {TRAIN_CHECK_STEPS} rollout steps launched K1 {len(k1_calls)} times")
        for t, (args, outs) in enumerate(zip(k1_calls, k1_outs)):
            hold_k1(pairwise.pairwise_rewards_plain, args, outs, f"{name} rollout step {t}")
        line = {"k1_shape": list(k1_calls[0][0].shape), "k1_steps": len(k1_calls),
                "k1_bitwise_equal": True,
                "k1_colliding": int(sum(int(o[0].sum()) for o in k1_outs)),
                "rewards_and_latch_bitwise_equal": True}
        want_k2 = TRAIN_CHECK_STEPS if name == "train_drl2" else 0
        check(len(k2_calls) == want_k2, f"{name}: K2 launched {len(k2_calls)} times")
        for t, (args, out) in enumerate(zip(k2_calls, k2_outs)):
            cells = args[9]
            check(cells.shape == (0, 2) and cells.is_cuda, f"static cells {tuple(cells.shape)}")
            ref = raymarch.raymarch_plain(*args)
            check(bitwise_equal(out, ref),
                  f"{name}: rollout step {t}: K2 not bitwise equal to the plain version")
            hits = int((ref < raymarch.LASER_MAX_RANGE).sum())
            check(hits > 0, f"{name}: no beam hit anything")
            line.update({"k2_shape": list(ref.shape), "k2_steps": len(k2_calls),
                         "static_cells": 0, "k2_bitwise_equal": True, "beams_hit": hits})
        result[name] = line
    print(json.dumps({"kernels_on_training": result}), flush=True)


# --------------------------------------------------------- evaluation suites

SUITE_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                               "torch_suite_jax_outcomes.json")
SUITE_K1_STEPS = 2     # first steps of each suite cell whose K1 launches are held bitwise
SUITE_K1_AGENTS = (2, 3, 4)   # the campaign's agent counts (the CLI runs 2 and 3)
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)   # where a replayed card trajectory parts from the CPU's
# 4-agent cells of lower precision that the outcome gate must reject
SUITE_CONTROLS = {"ga3c4_bf16_weights": ("GA3C-CADRL-10-bf16", False),
                  "ga3c4_tf32_products": ("GA3C-CADRL-10", True)}


def suite_cell(name, device, agents=None):
    """``(scenarios, cfg, params)`` of the suite cell ``name`` of
    ``harness/paths.py:SUITE_PATHS`` (at ``agents``, default its 4) with its
    params on ``device``."""
    from gym_collision_avoidance_torch.harness import experiments, paths

    return experiments.suite_cell(agents or paths.SUITE_AGENTS, paths.SUITE_PATHS[name],
                                  paths.SUITE_CASES, device=device)


def parting_step(card, cpu):
    """The first step of ``[T, A, 2]`` trajectories at which the card's
    positions leave the CPU's by more than ``TRAJ_TOL``, or None."""
    close = np.isclose(card, cpu, **TRAJ_TOL).all(axis=(1, 2))
    return None if close.all() else int(np.argmin(close))


def replay_differing(name, cases, ref, full, why="outcome differs from JAX", cell=None):
    """Replay the ``cases`` of ``name`` (those whose outcome differs from the
    JAX reference) as their own batch, on the card and on the port's CPU,
    with trajectories; the step at which the card's positions part from the
    CPU's.  An episode that parts at step 0 or 1 is a fault of the port.
    ``cell`` is ``(agents, policy)`` of a campaign cell outside
    ``SUITE_PATHS``."""
    from gym_collision_avoidance_torch.harness import experiments, paths

    out, runs = [], {}
    for device in (DEVICE, "cpu"):
        scenarios, cfg, params = (suite_cell(name, device) if cell is None else
                                  experiments.suite_cell(*cell, paths.SUITE_CASES,
                                                         device=device))
        runs[device] = experiments.run_batched_episodes(
            [scenarios[i] for i in cases], cfg, params, collect_trajectories=True,
            device=device)
    (card, card_traj), (cpu, cpu_traj) = runs[DEVICE], runs["cpu"]
    for j, case in enumerate(cases):
        T = max(card[j]["steps"], cpu[j]["steps"])
        part = parting_step(card_traj[:T, j], cpu_traj[:T, j])
        out.append({"case": case, "why": why, "jax": ref["outcome"][case],
                    "card": full[case]["outcome"],
                    "card_replayed": card[j]["outcome"], "cpu": cpu[j]["outcome"],
                    "steps": {"jax": ref["steps"][case], "card": full[case]["steps"],
                              "cpu": cpu[j]["steps"]},
                    "card_vs_cpu_parting_step": part})
    print(json.dumps({f"{name}_replayed_episodes": out}), flush=True)
    for row in out:
        check(row["card_vs_cpu_parting_step"] is None or row["card_vs_cpu_parting_step"] > 1,
              f"{name}: case {row['case']} parts from the CPU at step "
              f"{row['card_vs_cpu_parting_step']}: a fault of the port")
    return out


def phase_suite_4agent(kernels):
    """The 500 frozen 4-agent cases of each suite cell as one batch on the
    card (``run_episode_batch``, chunks of 128 steps): K1 once a lockstep
    step and no laser kernel, finite stats, and each cell held against the
    JAX package's per-episode outcomes (``SUITE_REFERENCE``) by
    ``experiments.compare_outcomes``: every outcome equal, step counts equal
    on all but 2% of the episodes; every differing episode replayed
    (:func:`replay_differing`)."""
    from gym_collision_avoidance_torch.harness import experiments, paths

    reference = experiments.load_outcome_records(SUITE_REFERENCE)
    by_cell, failed = {}, []
    for name, policy in paths.SUITE_PATHS.items():
        scenarios, cfg, params = suite_cell(name, DEVICE)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.LAUNCHES = 0
        t0 = time.perf_counter()
        run = experiments.run_episode_batch(scenarios, cfg, params, device=DEVICE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: k.LAUNCHES for n, k in kernels.items()}
        stats, steps = run.stats, run.lockstep_steps
        check(launches["pairwise"] == steps,
              f"{name}: K1 launched {launches['pairwise']} times in {steps} steps")
        check(launches["raymarch"] == 0 and launches["laser_fused"] == 0,
              f"{name}: a laser kernel launched")
        for s in stats:
            check(all(np.isfinite(np.asarray(s[k], np.float64)).all()
                      for k in ("total_reward", "time_to_goal", "extra_time_to_goal")),
                  f"{name}: non-finite episode stats")
        record = experiments.cell_record(paths.SUITE_AGENTS, policy, stats)
        ref = reference[(paths.SUITE_AGENTS, policy)]
        cmp = experiments.compare_outcomes(ref, record)
        line = {"policy": policy, "agents": paths.SUITE_AGENTS, "episodes": len(stats),
                "seconds": seconds, "lockstep_steps": steps,
                "episodes_per_s": len(stats) / seconds,
                "env_steps_per_s": len(stats) * steps / seconds,
                "ms_per_step": 1e3 * seconds / steps, "launches": launches,
                "summary": record["summary"], "jax_summary": ref["summary"],
                "outcome_agreement": cmp["outcome_agreement"],
                "steps_apart_cases": cmp["steps_apart_cases"],
                "pct_points_apart": cmp["pct_points_apart"],
                "differing_cases": cmp["differing_cases"]}
        print(json.dumps({name: line}), flush=True)
        if cmp["differing_cases"]:
            replay_differing(name, cmp["differing_cases"], ref, stats)
        else:
            # nothing differs: replay the two longest episodes, so the check
            # runs and says how long the card follows the CPU
            longest = sorted(range(len(stats)), key=lambda i: -stats[i]["steps"])[:2]
            replay_differing(name, sorted(longest), ref, stats, why="longest, none differs")
        if not cmp["ok"]:
            failed.append(name)
        by_cell[name] = launches
    check(not failed, f"{failed}: outcomes disagree with the JAX reference beyond "
          f"{experiments.MAX_OUTCOMES_APART} outcomes and "
          f"{experiments.MAX_STEPS_APART_SHARE:.0%} of the step counts")
    return by_cell


@contextlib.contextmanager
def tf32_env_steps(experiments):
    """TF32 matmuls inside every ``env_step`` of ``run_episode_batch`` (the
    entry points turn TF32 off when they set up)."""
    orig = experiments.env_step

    def step(*args):
        torch.backends.cuda.matmul.allow_tf32 = True
        return orig(*args)

    experiments.env_step = step
    try:
        yield
    finally:
        experiments.env_step = orig
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_suite_controls():
    """The outcome gate of ``phase_suite_4agent`` must reject GA3C-CADRL-10
    computing below float32: with bf16 weights (the registry's
    ``GA3C-CADRL-10-bf16``) and with TF32 products, each over the 500 frozen
    4-agent cases against the float32 JAX reference."""
    from gym_collision_avoidance_torch.harness import experiments, paths

    reference = experiments.load_outcome_records(SUITE_REFERENCE)
    ref = reference[(paths.SUITE_AGENTS, "GA3C-CADRL-10")]
    result = {}
    for name, (policy, tf32) in SUITE_CONTROLS.items():
        scenarios, cfg, params = experiments.suite_cell(paths.SUITE_AGENTS, policy,
                                                        paths.SUITE_CASES, device=DEVICE)
        with tf32_env_steps(experiments) if tf32 else contextlib.nullcontext():
            run = experiments.run_episode_batch(scenarios, cfg, params, device=DEVICE)
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 left on")
        record = experiments.cell_record(paths.SUITE_AGENTS, policy, run.stats)
        cmp = experiments.compare_outcomes(ref, record)
        result[name] = {"policy": policy, "tf32": tf32, "summary": record["summary"],
                        "outcomes_apart": len(cmp["differing_cases"]),
                        "steps_apart": len(cmp["steps_apart_cases"]),
                        "pct_points_apart": cmp["pct_points_apart"],
                        "rejected": not cmp["ok"]}
    print(json.dumps({"suite_controls": result}), flush=True)
    for name, line in result.items():
        check(line["rejected"], f"{name}: the outcome gate passed a cell below float32")


def phase_suite_k1():
    """K1's launches in the first SUITE_K1_STEPS steps of every suite cell
    the campaign runs (500 cases at 2, 3 and 4 agents, each policy), held
    bitwise against the plain version."""
    from gym_collision_avoidance_torch.harness import experiments, paths
    from gym_collision_avoidance_torch.ops import pairwise

    result = {}
    for agents in SUITE_K1_AGENTS:
        for name in paths.SUITE_PATHS:
            scenarios, cfg, params = suite_cell(name, DEVICE, agents)
            calls, outs = [], []
            with capture(pairwise, "pairwise_rewards_cuda", calls, outs):
                experiments.run_episode_batch(scenarios, cfg, params,
                                              chunk_steps=SUITE_K1_STEPS,
                                              max_steps=SUITE_K1_STEPS, device=DEVICE)
            torch.cuda.synchronize()
            cell = f"{paths.SUITE_PATHS[name]} at {agents} agents"
            check(len(calls) == SUITE_K1_STEPS,
                  f"{cell}: {SUITE_K1_STEPS} steps launched K1 {len(calls)} times")
            for t, (args, out) in enumerate(zip(calls, outs)):
                hold_k1(pairwise.pairwise_rewards_plain, args, out, f"{cell} step {t}")
            shape = list(calls[0][0].shape)
            check(shape == [paths.SUITE_CASES, agents, 2], f"{cell}: K1 ran at {shape}")
            result[cell] = {"k1_shape": shape, "k1_steps": len(calls),
                            "k1_bitwise_equal": True}
    print(json.dumps({"suite_k1": result}), flush=True)


def env_step_outputs(env, obs, rewards, game_over):
    """The gym env's last step as ``compare_steps`` takes it: its ``[1, A]``
    state, the host obs stacked back to ``[1, A, ...]`` tensors, rewards,
    game over and no info."""
    keys = obs[0].keys()
    stacked = {k: torch.as_tensor(np.stack([obs[i][k] for i in sorted(obs)]))[None]
               for k in keys}
    return (env.state.to("cpu"), stacked, torch.as_tensor(rewards)[None],
            torch.as_tensor([game_over]), {})


def gym_episode(label, make_env, max_steps):
    """One episode of the gym env on the card and on the CPU.  Step by step
    from the CPU's state, the card's step is held against the CPU's at the
    serving tolerances with the goal frame's slack, and K1's launch in the
    first card step bitwise against its plain version; run freely, both end
    at the same step with the same outcome."""
    from gym_collision_avoidance_torch.ops import pairwise

    envs = {d: make_env(d) for d in (DEVICE, "cpu")}
    for env in envs.values():
        env.reset()
    card, cpu = envs[DEVICE], envs["cpu"]
    worst, slackened = 0.0, 0
    calls, outs = [], []
    for step in range(1, max_steps + 1):
        card.state = cpu.state.to(DEVICE)
        want = env_step_outputs(cpu, *cpu.step()[:3])
        with capture(pairwise, "pairwise_rewards_cuda", calls, outs) if step == 1 \
                else contextlib.nullcontext():
            got = env_step_outputs(card, *card.step()[:3])
        slack, _turn, _apart = goal_frame_slack(want, got)
        w, n, _, _ = compare_steps(f"gymapi {label} step {step}", want, got, 1e-5, 1e-6,
                                   slack=slack)
        worst, slackened = max(worst, w), slackened + n
        if bool(want[3][0]):
            break
    check(bool(want[3][0]), f"gymapi {label}: no game over in {max_steps} steps")
    check(len(calls) == 1, f"gymapi {label}: the first step launched K1 {len(calls)} times")
    hold_k1(pairwise.pairwise_rewards_plain, calls[0], outs[0], f"gymapi {label} step 1")
    k1_shape = list(calls[0][0].shape)
    A = card.state.pos.shape[1]
    check(k1_shape == [1, A, 2], f"gymapi {label}: K1 ran at {k1_shape}")
    free = {}
    for device, env in envs.items():
        env.reset()
        for n in range(1, max_steps + 1):
            if env.step()[2]:
                break
        free[device] = (n, [(a.in_collision, a.is_at_goal) for a in env.agents],
                        env.state.pos.cpu())
    check(free[DEVICE][:2] == free["cpu"][:2],
          f"gymapi {label}: free runs end apart: card {free[DEVICE][:2]}, cpu {free['cpu'][:2]}")
    return {"lockstep_steps": step, "max_abs_err": worst, "k1_shape": k1_shape,
            "k1_bitwise_equal": True,
            "entries_within_frame_slack_only": slackened, "free_run_steps": free["cpu"][0],
            "free_run_max_pos_diff": max_abs_err(free[DEVICE][2], free["cpu"][2])}


def phase_gymapi():
    """``CollisionAvoidanceEnv(device="cuda")`` against ``device="cpu"``:
    NonCoop on ``two_agents_swap`` and GA3C-CADRL-10 on the 4-agent circle
    case, and ``apply_external_states`` on 2 EXTERNAL-dynamics agents (the
    velocity a true division by dt on both devices, so equal bits)."""
    from gym_collision_avoidance_torch import EnvConfig
    from gym_collision_avoidance_torch.core import dynamics as dyn
    from gym_collision_avoidance_torch.core.state import apply_external_states
    from gym_collision_avoidance_torch.env.gymapi import CollisionAvoidanceEnv
    from gym_collision_avoidance_torch.harness import registry as hreg
    from gym_collision_avoidance_torch.scenarios import presets, suites

    cfg = EnvConfig.evaluate(dtype="float32")
    ga3c_cfg = hreg.cfg_for_policy("GA3C-CADRL-10", cfg)
    circle = presets.from_cadrl_case(suites.gen_circle_test_case(4, 4.0), policy="GA3C_CADRL")
    result = {
        "noncoop_swap": gym_episode("noncoop_swap", lambda d: CollisionAvoidanceEnv(
            cfg=cfg, scenario=presets.two_agents_swap(), device=d), 300),
        "ga3c_circle4": gym_episode("ga3c_circle4", lambda d: CollisionAvoidanceEnv(
            cfg=ga3c_cfg, scenario=circle, device=d,
            params=hreg.load_params("ga3c_cadrl", device=d)), 400),
    }
    sc = presets.two_agents_swap(policy="external")
    sc.dynamics_id = np.full(2, dyn.EXTERNAL, np.int32)
    states = {}
    for device in (DEVICE, "cpu"):
        st = sc.to_state(cfg, device=device)
        st = apply_external_states(st, cfg, sc.pos[None] + 0.25)
        st = st.replace(step_num=torch.ones_like(st.step_num))
        states[device] = apply_external_states(st, cfg, sc.pos[None] + np.array([0.4, -0.1]))
    card, cpu = states[DEVICE].to("cpu"), states["cpu"]
    for leaf in ("pos", "vel", "speed"):
        check(bitwise_equal(getattr(card, leaf), getattr(cpu, leaf)),
              f"apply_external_states: {leaf} differs between card and CPU")
    check(bool((cpu.vel != 0).all()), "apply_external_states: no velocity interpolated")
    result["apply_external_states"] = {
        "pos_vel_speed_bitwise_equal": True,
        "heading_max_abs_err": max_abs_err(card.heading, cpu.heading)}
    check(result["apply_external_states"]["heading_max_abs_err"] <= 1e-6,
          "apply_external_states: headings differ")
    print(json.dumps({"gymapi": result}), flush=True)



# ------------------------------------------------------------- entry points

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "gym_collision_avoidance_torch", "models", "weights")
DRL_LONG_REFERENCE = os.path.join(ROOT, "tests", "data", "torch_drl_long_jax_outcomes.json")
ENTRY_K_STEPS = 2      # first steps of an entry point whose kernel launches are held bitwise
# scripts/eval_trained_net.py on the shipped flagship, the campaign's cells
FLAGSHIP = os.path.join(WEIGHTS, "ppo_selfplay_10agent_tpu.npz")
TRAINED_AGENTS = (2, 3, 4)
# scripts/train_example.py's defaults, and the iterations timed on the card
REINFORCE_ENVS, REINFORCE_HORIZON, REINFORCE_ITERS = 256, 40, 5
# a REINFORCE iteration on the card against the CPU's from the same draws
# (PR 7's rules for a training step: tests/test_torch_train_cuda.py)
REINFORCE_PARAMS_ATOL, REINFORCE_GRAD_RTOL = 1e-4, 1e-5


def script_module(name):
    """``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def hold_k2(calls, outs, what):
    """Each captured K2 launch bitwise against ``raymarch_plain`` on its
    arguments; returns the beams that hit something."""
    from gym_collision_avoidance_torch.ops import raymarch

    hits = 0
    for t, (args, out) in enumerate(zip(calls, outs)):
        ref = raymarch.raymarch_plain(*args)
        check(bitwise_equal(out, ref), f"{what} launch {t}: K2 not bitwise equal")
        hits += int((ref < raymarch.LASER_MAX_RANGE).sum())
    return hits


def drl_long_positions(cli, ckpt, ref, cases, device):
    """``evaluate_drl_long`` on the first ``max(cases) + 1`` cases on
    ``device``, keeping the ``[T, A, 2]`` positions of ``cases`` after every
    step (``env_step``'s states, captured)."""
    from gym_collision_avoidance_torch.env import step as env_step_module

    keep, orig = [], env_step_module.env_step

    def spy(*args):
        out = orig(*args)
        keep.append(out[0].pos[list(cases)].cpu().numpy())
        return out

    env_step_module.env_step = spy
    try:
        cli.evaluate_drl_long(ckpt, ref["agents"], max(cases) + 1, ref["steps"], device=device)
    finally:
        env_step_module.env_step = orig
    return np.stack(keep, axis=1)                      # [cases, T, A, 2]


def phase_eval_drl_long(kernels):
    """``scripts/eval_drl_long_torch.py:evaluate_drl_long`` at the script's
    width: the shipped DRL-Long net greedy as agent 0 against RVO on the 500
    frozen 2-agent cases, E = 500, 250 steps (K1 at [500, 2] once a step; K2
    at [500, 2, 512] once a step and once at the reset), counts from 0, timed.
    K1's launches in the first ENTRY_K_STEPS steps, and K2's at the reset and
    in those steps, are held bitwise.  Each case's at-goal, collision and
    timeout flags are held against
    the JAX script's (``tests/data/torch_drl_long_jax_outcomes.json``).  A
    differing case is replayed on the card and the CPU to the step at which
    the two part, and the phase fails."""
    from gym_collision_avoidance_torch.ops import pairwise, raymarch

    cli = script_module("eval_drl_long_torch")
    with open(DRL_LONG_REFERENCE) as f:
        ref = json.load(f)
    ckpt = os.path.join(WEIGHTS, ref["ckpt"])
    A, E, T = ref["agents"], ref["cases"], ref["steps"]
    k1, k1_out, k2, k2_out = [], [], [], []
    zero_counts(kernels)
    t0 = time.perf_counter()
    with capture(pairwise, "pairwise_rewards_cuda", k1, k1_out, ENTRY_K_STEPS), \
            capture(raymarch, "raymarch_cuda", k2, k2_out, ENTRY_K_STEPS + 1):
        out = cli.evaluate_drl_long(ckpt, A, E, T, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = rank_counts(kernels)
    check(launches == {"pairwise": T, "raymarch": T + 1, "laser_fused": 0},
          f"eval_drl_long: launches {launches} in {T} steps")
    # the reset's and the first steps' launches
    k1_err = max(hold_k1(pairwise.pairwise_rewards_plain, args, out_k, f"eval_drl_long step {t}")
                 for t, (args, out_k) in enumerate(zip(k1, k1_out)))
    hits = hold_k2(k2, k2_out, "eval_drl_long")
    shapes = {"k1": list(k1[0][0].shape[:2]), "k2": list(k2_out[0].shape)}
    check(shapes == {"k1": [E, A], "k2": [E, A, 512]}, f"eval_drl_long: shapes {shapes}")
    del k1, k1_out, k2, k2_out
    flags = ("at_goal", "collision", "timeout")
    differ = sorted({int(i) for k in flags for i in np.flatnonzero(out[k] != np.asarray(ref[k]))})

    def pct(o):
        at_goal, coll, timeout = (np.asarray(o[k], bool) for k in flags)
        return {"success": 100 * float((at_goal & ~coll).mean()),
                "collision": 100 * float(coll.mean()),
                "timeout_stuck": 100 * float((timeout & ~coll & ~at_goal).mean())}

    line = {"device": nvidia_smi_line(), "ckpt": ref["ckpt"], "agents": A, "cases": E,
            "steps": T, "seconds": seconds, "env_steps_per_s": E * T / seconds,
            "ms_per_step": 1e3 * seconds / T, "launches": launches, "pct": pct(out),
            "jax_pct": pct(ref), "differing_cases": [int(i) for i in differ],
            "k_held_steps": ENTRY_K_STEPS, "k1_k2_bitwise_equal": True,
            "k1_max_abs_err": k1_err, "k2_beams_hit": hits, "shapes": shapes}
    print(json.dumps({"eval_drl_long": line}), flush=True)
    print("\n".join(cli.outcome_lines(ref["ckpt"], A, out)), flush=True)
    if differ:
        card = drl_long_positions(cli, ckpt, ref, differ, DEVICE)
        cpu = drl_long_positions(cli, ckpt, ref, differ, "cpu")
        print(json.dumps({"eval_drl_long_replayed_cases": [
            {"case": int(c), "jax": {k: ref[k][c] for k in flags},
             "card": {k: bool(out[k][c]) for k in flags},
             "card_vs_cpu_parting_step": parting_step(card[j], cpu[j])}
            for j, c in enumerate(differ)]}), flush=True)
    check(not differ, f"eval_drl_long: cases {differ} differ from the JAX script's outcome")
    return {"eval_drl_long": launches}


def phase_eval_trained_net(kernels, trained_ga3c4):
    """``scripts/eval_trained_net_torch.py:evaluate_trained_net`` on the
    shipped flagship ``ppo_selfplay_10agent_tpu`` over the 500 frozen cases
    of the 2-, 3- and 4-agent cells, each cell timed, K1 once a lockstep
    step, and held against the JAX package's outcomes in
    ``tests/data/torch_suite_jax_outcomes.json`` by ``compare_outcomes``
    (every differing episode replayed); K1's first ENTRY_K_STEPS launches of
    each cell held bitwise.  Then the net that ``train_ga3c4``
    trained on the card, exported as ``train_ppo_torch.py --export-params``
    writes it, scored on the 4-agent cell: a run of the pipeline, no
    outcome gate."""
    import tempfile

    from gym_collision_avoidance_torch import convert
    from gym_collision_avoidance_torch.harness import experiments
    from gym_collision_avoidance_torch.ops import pairwise

    cli = script_module("eval_trained_net_torch")
    reference = experiments.load_outcome_records(SUITE_REFERENCE)
    smi = nvidia_smi_line()
    by_cell, failed = {}, []
    for n in TRAINED_AGENTS:
        calls, outs = [], []
        zero_counts(kernels)
        t0 = time.perf_counter()
        with capture(pairwise, "pairwise_rewards_cuda", calls, outs, ENTRY_K_STEPS):
            name, runs = cli.evaluate_trained_net(FLAGSHIP, (n,), device=DEVICE)
        seconds = time.perf_counter() - t0
        launches = rank_counts(kernels)
        run = runs[n]
        k1_err = max(hold_k1(pairwise.pairwise_rewards_plain, args, out, f"{name} at {n}")
                     for args, out in zip(calls, outs))
        shape = list(calls[0][0].shape[:2])
        check(shape == [len(run.stats), n], f"{name} at {n}: K1 held at {shape}")
        del calls, outs
        check(launches == {"pairwise": run.lockstep_steps, "raymarch": 0, "laser_fused": 0},
              f"{name} at {n}: launches {launches} in {run.lockstep_steps} steps")
        record = experiments.cell_record(n, name, run.stats)
        ref = reference[(n, name)]
        cmp = experiments.compare_outcomes(ref, record)
        print(json.dumps({f"eval_trained_net_{n}agent": {
            "device": smi, "policy": name, "agents": n, "episodes": len(run.stats),
            "seconds": seconds, "lockstep_steps": run.lockstep_steps,
            "episodes_per_s": len(run.stats) / seconds,
            "env_steps_per_s": len(run.stats) * run.lockstep_steps / seconds,
            "launches": launches, "summary": record["summary"], "jax_summary": ref["summary"],
            "outcome_agreement": cmp["outcome_agreement"],
            "differing_cases": cmp["differing_cases"],
            "steps_apart_cases": cmp["steps_apart_cases"],
            "k1_held_at": shape, "k1_bitwise_equal": True, "k1_max_abs_err": k1_err}}),
            flush=True)
        if cmp["differing_cases"]:
            replay_differing(f"eval_trained_net_{n}agent", cmp["differing_cases"], ref,
                             run.stats, cell=(n, name))
        if not cmp["ok"]:
            failed.append(n)
        by_cell[f"eval_trained_net_{n}agent"] = launches
    check(not failed, f"eval_trained_net: the {failed}-agent cells disagree with the JAX "
          "reference beyond the gate")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trained_") as tmp:
        ckpt = os.path.join(tmp, "card_trained_ga3c4.npz")
        np.savez(ckpt, **convert.ppo_params_to_numpy("ga3c", trained_ga3c4))
        t0 = time.perf_counter()
        name, runs = cli.evaluate_trained_net(ckpt, (4,), device=DEVICE)
        seconds = time.perf_counter() - t0
    run = runs[4]
    summary = experiments.summarize_stats(run.stats)
    check(all(math.isfinite(summary[k]) for k in ("pct_success", "pct_collision")),
          f"{name}: non-finite summary {summary}")
    print(json.dumps({"eval_card_trained_net": {
        "device": smi, "net": "train_ga3c4's net after its phase, exported", "agents": 4,
        "episodes": len(run.stats), "seconds": seconds, "lockstep_steps": run.lockstep_steps,
        "summary": summary}}), flush=True)
    print("\n".join(experiments.summary_table([{"num_agents": 4, "policy": name, **summary}])),
          flush=True)
    return by_cell


def phase_reinforce(kernels):
    """``scripts/train_example_torch.py`` at the CLI's defaults (E = 256,
    T = 40, 2 agents; K1 at [256, 2] once a rollout step).  One iteration on
    the card from the CPU's initial weights and noise against the same
    iteration on the CPU: parameters within REINFORCE_PARAMS_ATOL, gradients
    within REINFORCE_GRAD_RTOL of each tensor's largest CPU entry, K1's first
    ENTRY_K_STEPS launches held bitwise.  Then REINFORCE_ITERS iterations
    from a generator on the card, counts from 0 (after a warm-up
    iteration), timed: ms per iteration and the returns, all finite."""
    from gym_collision_avoidance_torch.ops import pairwise
    from gym_collision_avoidance_torch.train import optim

    cli = script_module("train_example_torch")
    E, T = REINFORCE_ENVS, REINFORCE_HORIZON
    trainers = {d: cli.Reinforce(E, T, device=d) for d in (DEVICE, "cpu")}
    gen = torch.Generator().manual_seed(0)
    init = {k: v.detach() for k, v in trainers["cpu"].init_policy(gen).items()}
    eps = torch.randn((T, E, 2), generator=gen)
    steps = {}
    calls, outs = [], []
    zero_counts(kernels)
    for d, trainer in trainers.items():
        p = {k: v.to(d).requires_grad_(True) for k, v in init.items()}
        with capture(pairwise, "pairwise_rewards_cuda", calls, outs, ENTRY_K_STEPS):
            p, _opt, loss, ret, grads = trainer.train_step(p, optim.init(p), eps.to(d))
        steps[d] = {"params": {k: v.detach().cpu() for k, v in p.items()},
                    "grads": {k: v.cpu() for k, v in grads.items()},
                    "loss": float(loss), "mean_return": float(ret)}
    check(pairwise.LAUNCHES == T, f"reinforce: K1 launched {pairwise.LAUNCHES} times in {T} "
          "steps")
    k1_err = max(hold_k1(pairwise.pairwise_rewards_plain, args, out, f"reinforce step {t}")
                 for t, (args, out) in enumerate(zip(calls, outs)))
    shape = list(calls[0][0].shape[:2])
    del calls, outs
    card, cpu = steps[DEVICE], steps["cpu"]
    params_diff = max(max_abs_err(card["params"][k], cpu["params"][k]) for k in cpu["params"])
    grad_ratio = max(max_abs_err(card["grads"][k], g) / float(g.abs().max())
                     for k, g in cpu["grads"].items())
    check(params_diff <= REINFORCE_PARAMS_ATOL,
          f"reinforce: parameters apart by {params_diff} after one iteration")
    check(grad_ratio <= REINFORCE_GRAD_RTOL,
          f"reinforce: gradients apart by {grad_ratio} of their largest entry")

    trainer = trainers[DEVICE]
    gen = torch.Generator(DEVICE).manual_seed(0)
    trainer.run(1, generator=gen)
    zero_counts(kernels)
    t0 = time.perf_counter()
    params, rets = trainer.run(REINFORCE_ITERS, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rank_counts(kernels)
    check(launches == {"pairwise": REINFORCE_ITERS * T, "raymarch": 0, "laser_fused": 0},
          f"reinforce: launches {launches} in {REINFORCE_ITERS} iterations of {T} steps")
    check(all(math.isfinite(r) for r in rets), f"reinforce: non-finite returns {rets}")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()),
          "reinforce: non-finite parameters")
    print(json.dumps({"reinforce": {
        "device": nvidia_smi_line(), "num_envs": E, "horizon": T, "agents": 2,
        "one_iteration_card_vs_cpu": {
            "params_max_abs_diff": params_diff, "grads_max_diff_over_largest": grad_ratio,
            "loss": [card["loss"], cpu["loss"]],
            "mean_return": [card["mean_return"], cpu["mean_return"]],
            "k1_held_at": shape, "k1_bitwise_equal": True, "k1_max_abs_err": k1_err},
        "iterations": REINFORCE_ITERS, "seconds": seconds,
        "ms_per_iteration": 1e3 * seconds / REINFORCE_ITERS,
        "env_steps_per_s": REINFORCE_ITERS * E * T / seconds, "launches": launches,
        "mean_returns": rets}}), flush=True)
    return {"reinforce": launches}


# ------------------------------------------- the benchmark's rows

BENCH_ROW_STEPS = 8    # steps a dispatch of each row in the bench_rows phase


def root_module(name):
    """``<name>.py`` at the root of the checkout as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def host_syncs(counts):
    """Append to ``counts`` the number of synchronising CUDA calls (host
    reads of device values) made in the block, from torch's sync debug
    mode."""
    import warnings

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    counts.append(sum("synchroniz" in str(w.message) for w in seen))


def bench_row_envs(bench):
    """The bench's env count at which the JAX repo runs each row of
    ``scripts/bench_all.py``: ``bench.py``'s profile rows and headline (the
    autoreset4 loop), ``bench_ga3c40``'s official 16384, and the script's
    default 4096 for the rest."""
    envs = {name: 4096 for name in bench.bench_all_torch.CONFIGS}
    envs.update({name: e for name, _, (e, _), _ in bench.PROFILE_ROWS})
    envs.update(autoreset4=bench.HEADLINE["num_envs"], ga3c40=16384)
    return envs


def phase_bench_rows(kernels):
    """Every row of ``scripts/bench_all_torch.py`` once at its env count
    (:func:`bench_row_envs`), BENCH_ROW_STEPS steps a dispatch, one window
    of one dispatch after the warm-up, counts from 0 before each row: K1
    once a step (a training iteration's 64 rollout steps on ppo_train), K3
    once a step on ga3c20_laser, nothing else.  ga3c40's first
    ENTRY_K_STEPS K1 launches are held bitwise at ``[E, 40]``.  The host
    reads inside each timed window are counted a step as torch's sync debug
    mode's warnings, beside what it counts for one read of each form.  Then
    ``bench_torch.py``'s tripwire on the card: clean it passes (K1 launched
    on the kernel route only), with TF32 products on the kernel route it
    trips."""
    from gym_collision_avoidance_torch.ops import pairwise

    bench = root_module("bench_torch")
    rows = bench.bench_all_torch
    envs = bench_row_envs(bench)
    # what sync debug mode counts for one read of each form (ORCA's LP3 flag
    # is a bool(x.any())), after a read whose count is dropped: the first read
    # the mode sees in a process has counted twice
    probe = torch.ones(1, device=DEVICE)
    with host_syncs([]):
        probe.item()
    calibration = {}
    for form, read in (("bool(x.any())", lambda: bool(probe.any())),
                       (".item()", lambda: probe.item())):
        counts = []
        with host_syncs(counts):
            read()
        calibration[form] = counts[0]
    timed = rows.timed_windows
    by_path, lines = {}, {}
    try:
        for name, fn in rows.CONFIGS.items():
            syncs = []

            def counted(device, dispatch, work, reps, pipeline):
                def spy():
                    with host_syncs(syncs):
                        return dispatch()
                return timed(device, spy, work, reps, pipeline)

            rows.timed_windows = counted
            calls, outs = [], []
            zero_counts(kernels)
            with capture(pairwise, "pairwise_rewards_cuda", calls, outs,
                         ENTRY_K_STEPS if name == "ga3c40" else 0):
                row = fn(envs[name], BENCH_ROW_STEPS, device=DEVICE, reps=1, pipeline=1)
            torch.cuda.synchronize()
            launches = rank_counts(kernels)
            steps = 2 * row["num_steps"]                  # the warm-up and the window
            want = {"pairwise": steps, "raymarch": 0,
                    "laser_fused": steps if name == "ga3c20_laser" else 0}
            check(launches == want, f"bench_rows {name}: launches {launches}, not {want}")
            check(row["env_steps_per_sec"] > 0 and row.get("nan_free", True),
                  f"bench_rows {name}: {row}")
            line = {"num_envs": row["num_envs"], "steps": steps,
                    "env_steps_per_s": row["env_steps_per_sec"],
                    "ms_per_step": 1e3 * row["num_envs"] / row["env_steps_per_sec"],
                    "sync_warnings_per_step": sum(syncs) / row["num_steps"],
                    "launches": launches}
            if name == "ga3c40":
                line["k1_max_abs_err"] = max(
                    hold_k1(pairwise.pairwise_rewards_plain, args, out, f"ga3c40 step {t}")
                    for t, (args, out) in enumerate(zip(calls, outs)))
                line["k1_held_at"] = list(calls[0][0].shape[:2])
                check(line["k1_held_at"] == [envs[name] // 32, 40],
                      f"bench_rows ga3c40: K1 at {line['k1_held_at']}")
            del calls, outs
            lines[name] = line
            by_path[f"bench_{name}"] = launches
    finally:
        rows.timed_windows = timed
    zero_counts(kernels)
    clean = bench._exactness_check(DEVICE)
    k1_clean = pairwise.LAUNCHES
    fault = bench._exactness_check(DEVICE, fault=True)
    check(clean == "ok", f"bench_rows: the clean tripwire failed: {clean}")
    check(fault.startswith("MISMATCH"), f"bench_rows: the TF32 fault did not trip: {fault}")
    check(k1_clean == bench.EXACTNESS_STEPS and pairwise.LAUNCHES == 2 * k1_clean,
          f"bench_rows: K1 launched {k1_clean}, {pairwise.LAUNCHES} times in the tripwire")
    print(json.dumps({"bench_rows": {
        "device": nvidia_smi_line(), "steps_per_dispatch": BENCH_ROW_STEPS,
        "sync_warnings_per_read": calibration, "rows": lines,
        "tripwire": {"num_envs": bench.EXACTNESS_ENVS, "steps": bench.EXACTNESS_STEPS,
                     "clean": clean, "tf32_fault": fault}}}), flush=True)
    return by_path


# ------------------------------------------- data parallelism, strict parity

PAR_RANKS = 2                     # ranks sharing the one card (gloo, CUDA tensors)
PAR_GA3C_STEPS = 64               # steps of parallel_ga3c4's one dispatch
PAR_ROLLOUT_ENVS, PAR_ROLLOUT_STEPS = 1024, 32   # make_distributed_rollout, gloo and NCCL
STRICT_ENVS, STRICT_STEPS = 64, 32
# a card run of one minibatch step from one carry, 2 ranks against 1: params
# within the CPU test's limit for the port against itself
# (tests/test_torch_distributed.py, PARAMS_ATOL["port", "mlp"]), and the
# applied gradients within a fraction of each tensor's largest entry
SHARDED_PARAMS_ATOL = 1e-7
SHARDED_GRADS_RTOL = 1e-5


def hold_reduced(name, got, want):
    """A metric reduced over the ranks against the 1-rank value: within rtol
    1e-6 (``tests/test_parallel.py``'s limit for the obs checksum) plus atol
    1e-6 of the dispatch's mean magnitude, because a reward sum cancels
    (goals +1 against penalties of -0.1 to -0.25: the main path's mean reward
    differs by 1.5e-6 relative, 3.7e-9 absolute, between a sum of 4096 envs
    and one of two halves on the CPU).  Returns the largest difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = float(np.max(np.abs(got - want)))
    check(np.allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.mean(np.abs(want)))),
          f"{name} apart by {diff} (values {want[:4].tolist()} ...)")
    return diff


def state_leaves(state):
    from gym_collision_avoidance_torch import convert

    return convert.state_to_numpy(state)


def leaves_differ(got, want):
    """The names of the leaves of ``{name: array}`` that are not bitwise
    equal (NaN where NaN)."""
    return sorted(k for k in want if not np.array_equal(got[k], want[k], equal_nan=True))


def joined(results, case, key):
    """The ranks' ``key`` results of ``case``, joined along the env axis."""
    parts = [r[case][key] for r in results]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([np.asarray(p[k]) for p in parts]) for k in parts[0]}
    return np.concatenate([np.asarray(p) for p in parts])


def rank_counts(kernels):
    return {n: k.LAUNCHES for n, k in kernels.items()}


def zero_counts(kernels):
    torch.cuda.synchronize()
    for k in kernels.values():
        k.LAUNCHES = 0


@contextlib.contextmanager
def held_k1(mesh, what, held):
    """Capture K1's launches (with the reward epilogue) in the block and
    hold the first two bitwise against the plain version; appends
    ``{"shape", "max_abs_err"}`` to ``held``."""
    from gym_collision_avoidance_torch.ops import pairwise

    calls, outs = [], []
    with capture(pairwise, "pairwise_rewards_cuda", calls, outs):
        yield
    check(len(calls) >= 2, f"{what}: K1 launched {len(calls)} times")
    err = max(hold_k1(pairwise.pairwise_rewards_plain, calls[i], outs[i],
                      f"{what} rank {mesh.rank} launch {i}")
              for i in range(2))
    held.append({"shape": list(calls[0][0].shape[:2]), "max_abs_err": err})


def check_held(ranks, what, shape):
    """Each rank's K1 launches held bitwise (:func:`held_k1`) ran at
    ``shape`` ``[E/D, A]``; returns the held shapes and their largest gap
    difference."""
    for r in ranks:
        for h in r["k1_held"]:
            check(h["shape"] == shape, f"{what}: K1 held at {h['shape']}, not {shape}")
    return {"k1_held_bitwise_at": [h["shape"] for r in ranks for h in r["k1_held"]],
            "k1_held_max_abs_err": max(h["max_abs_err"] for r in ranks for h in r["k1_held"])}


def record_grads(trainer):
    """Keep the gradients that each of ``trainer``'s minibatch steps
    applies (averaged over the ranks), ``{name: array}``, in the list it
    returns."""
    seen, step = [], trainer.minibatch_step

    def spy(params, opt_state, mb):
        out = step(params, opt_state, mb)
        seen.append({k: v.detach().cpu().numpy().copy() for k, v in out[0].items()})
        return out

    trainer.minibatch_step = spy
    return seen


def ranks_loss(trainer, perm, parts):
    """Make an unsharded ``trainer``'s loss, for one epoch of one minibatch
    shuffled by ``perm``, the mean over ``parts`` ranks of each one's loss on
    its own streams (row ``i`` is a sample of stream ``perm[i // T]``): the
    loss whose gradient a sharded run averages, each rank normalising its
    alive-weighted means by its own alive count, as the JAX package's
    ``pmean`` of the shards' gradients does."""
    shard = (perm // (trainer.B // parts)).repeat_interleave(trainer.ppo.horizon)
    loss_fn = trainer.loss_fn

    def loss(params, mb):
        out = [loss_fn(params, {k: v[shard == r] for k, v in mb.items()}) for r in range(parts)]
        return sum(o[0] for o in out) / parts, out[0][1]

    trainer.loss_fn = loss
    return trainer


def rank_serving(mesh, kernels):
    """The main path's AutoresetServer on this rank's slice of its 16384
    envs: 4 dispatches of 128 steps (the last 3 timed), K1 counted from 0 and
    its first 2 launches captured and held bitwise against the plain
    version."""
    from gym_collision_avoidance_torch.harness import paths

    path = paths.serving_path("main", mesh.device)
    server = path.server(steps_per_dispatch=STEPS_PER_DISPATCH, mesh=mesh)
    zero_counts(kernels)
    dispatches, held = [], []
    with held_k1(mesh, "parallel_serving", held):
        dispatches.append(server.dispatch())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCHES - 1):
        dispatches.append(server.dispatch())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"launches": rank_counts(kernels), "k1_held": held, "seconds": seconds,
            "timed_steps": (DISPATCHES - 1) * STEPS_PER_DISPATCH,
            "outs": [{k: v.cpu() for k, v in d.items()} for d in dispatches],
            "states": state_leaves(server.states()), "counters": server._counters.cpu(),
            "episodes": server.episodes_completed()}


def rank_ga3c4(mesh, kernels):
    """One dispatch of ga3c4 on this rank's slice of its 4096 envs, the
    iros18 weights broadcast from rank 0; K1 counted from 0 and held."""
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.parallel import distributed

    path = paths.serving_path("ga3c4", mesh.device)
    distributed.replicate_global(path.params, mesh)
    server = path.server(steps_per_dispatch=PAR_GA3C_STEPS, mesh=mesh)
    zero_counts(kernels)
    held = []
    with held_k1(mesh, "parallel_ga3c4", held):
        out = server.dispatch()
    return {"launches": rank_counts(kernels), "k1_held": held,
            "states": state_leaves(server.states()),
            "counters": server._counters.cpu(), "mean_reward": out["mean_reward"].cpu(),
            "obs_checksum": out["obs_checksum"].cpu()}


def rollout_states(device):
    """PAR_ROLLOUT_ENVS main-path envs, one pool case each, after a reset."""
    from gym_collision_avoidance_torch.env import autoreset
    from gym_collision_avoidance_torch.env.step import env_reset
    from gym_collision_avoidance_torch.harness import paths

    path = paths.serving_path("main", device)
    pool = paths.one_case_per_env(PAR_ROLLOUT_ENVS, len(path.policy_id))
    return path, env_reset(autoreset.state_from_case(path.cfg, pool, path.policy_id,
                                                     device=device), path.cfg)[0]


def rank_rollout(mesh, kernels):
    """``make_distributed_rollout`` of PAR_ROLLOUT_STEPS steps on this rank's
    slice of PAR_ROLLOUT_ENVS envs; K1 counted from 0 and held."""
    from gym_collision_avoidance_torch.parallel import distributed, mesh as pmesh

    path, states = rollout_states(mesh.device)
    local = distributed.host_local_batch(lambda idx: pmesh.shard_env_batch(states, mesh),
                                         PAR_ROLLOUT_ENVS, mesh)
    run = distributed.make_distributed_rollout(path.cfg, PAR_ROLLOUT_STEPS, mesh, path.active)
    zero_counts(kernels)
    held = []
    with held_k1(mesh, f"rollout over {mesh.backend}", held):
        final, metrics = run(local)
    return {"launches": rank_counts(kernels), "k1_held": held, "states": state_leaves(final),
            "metrics": {k: v.cpu() for k, v in metrics.items()}}


def sharded_mlp2():
    """train_mlp2's path and its recipe cut to 1 epoch x 1 minibatch."""
    from gym_collision_avoidance_torch.harness import paths

    path = paths.training_path("train_mlp2")
    return path, dataclasses.replace(path.ppo, epochs=1, num_minibatches=1)


def rank_sharded_ppo(mesh, kernels):
    """train_mlp2 on this rank's 512 of its 1024 envs: one 1 x 1 iteration
    from ``init_fn``'s carry and seed 7 (K1 held, the applied gradients
    kept), then one timed 4 x 4 iteration (after a warm-up) with its phase
    split, K1 counted from 0."""
    from gym_collision_avoidance_torch import convert
    from gym_collision_avoidance_torch.train import make_sharded_ppo

    path, ppo1 = sharded_mlp2()
    step, init_fn, _ = make_sharded_ppo(ppo1, mesh, pool=path.pool)
    params, opt, states, counters, obs = init_fn(ppo1.seed)
    grads, held = record_grads(step.__self__), []
    with held_k1(mesh, "sharded_ppo", held):
        out = step(params, opt, states, counters, obs,
                   rng=torch.Generator(mesh.device).manual_seed(7))
    result = {"params": convert.ppo_params_to_numpy("mlp", out[0]), "grads": grads,
              "k1_held": held,
              "states": state_leaves(out[2]), "counters": out[3].cpu(),
              "metrics": {k: float(v) for k, v in out[5].items()}}
    step4, init4, _ = make_sharded_ppo(path.ppo, mesh, pool=path.pool)
    carry, gen = init4(path.ppo.seed), torch.Generator(mesh.device).manual_seed(7)
    *carry, _ = step4(*carry, rng=gen)
    zero_counts(kernels)
    timings = {}
    t0 = time.perf_counter()
    *carry, metrics = step4(*carry, rng=gen, timings=timings)
    torch.cuda.synchronize()
    result.update(seconds=time.perf_counter() - t0, timings=timings,
                  launches=rank_counts(kernels),
                  metrics4={k: float(v) for k, v in metrics.items()})
    return result


def rank_sharded_resume(mesh, kernels, out_dir):
    """train_mlp2's recipe (E = 1024, T = 64, 4 x 4 minibatches) on this
    rank's rows: 2 iterations from ``init_fn``'s carry and a generator seeded
    7 (K1 counted from 0, its first launches held), saved with
    ``save_sharded_state``; then 1 iteration from the same start, a save, a
    new trainer resuming from that file (``load_sharded_state``) and 1 more
    iteration, saved.  Rank 0 lists the leaves of the two files that are not
    bitwise equal."""
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.parallel import distributed
    from gym_collision_avoidance_torch.train import make_sharded_ppo
    from gym_collision_avoidance_torch.train.ppo import CARRY_ENV_ROWS

    path = paths.training_path("train_mlp2")
    files = {k: os.path.join(out_dir, f"resume_{mesh.backend}_{k}.npz")
             for k in ("two", "one", "resumed")}

    def start():
        step, init_fn, _ = make_sharded_ppo(path.ppo, mesh, pool=path.pool)
        return step, tuple(init_fn(path.ppo.seed)), torch.Generator(mesh.device).manual_seed(7)

    def iterate(step, carry, gen):
        *carry, _metrics = step(*carry, rng=gen)
        return tuple(carry)

    def save(name, carry, gen):
        distributed.save_sharded_state(files[name], carry + (gen,), CARRY_ENV_ROWS, mesh)

    step, carry, gen = start()
    zero_counts(kernels)
    held = []
    t0 = time.perf_counter()
    with held_k1(mesh, "sharded_resume", held):
        carry = iterate(step, carry, gen)
    carry = iterate(step, carry, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rank_counts(kernels)
    save("two", carry, gen)
    step, carry, gen = start()
    save("one", iterate(step, carry, gen), gen)
    step, carry, gen = start()
    *carry, gen = distributed.load_sharded_state(files["one"], carry + (gen,), CARRY_ENV_ROWS,
                                                 mesh)
    save("resumed", iterate(step, tuple(carry), gen), gen)
    apart, leaves = [], 0
    if mesh.rank == 0:
        with np.load(files["two"]) as two, np.load(files["resumed"]) as resumed:
            leaves = len(two.files)
            apart = sorted(set(two.files) ^ set(resumed.files)) + [
                k for k in two.files if k in resumed.files and (
                    two[k].dtype != resumed[k].dtype or two[k].tobytes() != resumed[k].tobytes())]
    return {"launches": launches, "k1_held": held, "seconds_two_iterations": seconds,
            "leaves": leaves, "leaves_apart": apart,
            "file_bytes": os.path.getsize(files["two"])}


def rank_dryrun(mesh, kernels):
    """``entry.dryrun_rank`` on this rank's 2 envs (the batched GA3C step
    twice, the distributed rollout, one sharded PPO iteration, two sharded
    serving dispatches), K1's first 2 launches (the batched step's, at [2,
    4]) held bitwise."""
    from gym_collision_avoidance_torch import entry

    held = []
    with held_k1(mesh, f"dryrun over {mesh.backend}", held):
        result = entry.dryrun_rank(mesh)
    return dict(result, k1_held=held)


RANK_CASES = {"serving": rank_serving, "ga3c4": rank_ga3c4, "rollout": rank_rollout,
              "sharded_ppo": rank_sharded_ppo, "dryrun": rank_dryrun}


def rank_main(argv):
    """A rank of a spawned job: ``--rank-job BACKEND CASES`` and the flags
    that ``run_rank_job`` appends.  Runs each case on this rank's slice and
    saves ``{case: result}`` for the parent."""
    import argparse

    from gym_collision_avoidance_torch.ops import laser_fused, pairwise, raymarch
    from gym_collision_avoidance_torch.parallel import distributed, mesh as pmesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank-job", nargs=2, metavar=("BACKEND", "CASES"))
    distributed.add_rank_flags(ap)
    args = ap.parse_args(argv)
    backend, cases = args.rank_job
    distributed.init_distributed(backend, num_processes=args.num_processes,
                                 process_id=args.process_id, init_method=args.init_method)
    mesh = pmesh.make_mesh(device_type="cuda", device=torch.device(DEVICE, 0))
    kernels = {"pairwise": pairwise, "raymarch": raymarch, "laser_fused": laser_fused}
    result = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
              "device": str(mesh.device)}
    rank_cases = dict(RANK_CASES, sharded_resume=functools.partial(rank_sharded_resume,
                                                                   out_dir=args.rank_out))
    for case in cases.split(","):
        t0 = time.perf_counter()
        result[case] = rank_cases[case](mesh, kernels)
        result[case]["case_seconds"] = time.perf_counter() - t0
    distributed.save_rank_result(args, mesh, result)
    return 0


def phase_parallel_ranks():
    """The spawned jobs: 2 ranks on the one card over gloo (CUDA tensors go
    through the host: NCCL refuses two ranks on one card, and the backend is
    chosen here, never by a fallback) running serving, ga3c4, the rollout,
    the sharded trainer, the sharded resume and the dry run's rank body; then
    1 rank over NCCL running the rollout, the resume and the dry run.  The
    kernels are built already, so the ranks only load them."""
    from gym_collision_avoidance_torch.parallel import distributed

    results = {}
    script = os.path.abspath(__file__)
    for label, backend, ranks, cases in (("gloo", "gloo", PAR_RANKS,
                                          "serving,ga3c4,rollout,sharded_ppo,sharded_resume,"
                                          "dryrun"),
                                         ("nccl", "nccl", 1, "rollout,sharded_resume,dryrun")):
        t0 = time.perf_counter()
        results[label] = distributed.run_rank_job([sys.executable, script, "--rank-job",
                                                   backend, cases], ranks, threads=None,
                                                  timeout=600)
        print(json.dumps({"parallel_ranks": {
            "backend": backend, "ranks": ranks, "seconds": time.perf_counter() - t0,
            "case_seconds": [{c: r[c]["case_seconds"] for c in cases.split(",")}
                             for r in results[label]]}}), flush=True)
    for r in results["gloo"]:
        check((r["backend"], r["size"], r["device"]) == ("gloo", PAR_RANKS, "cuda:0"),
              f"gloo rank {r['rank']}: {r['backend']}, {r['size']} ranks, {r['device']}")
    check(results["nccl"][0]["backend"] == "nccl", "the one-rank mesh is not NCCL")
    return results


def phase_parallel_serving(results, kernels):
    """The main path (E = 16384) on 2 ranks of 8192 envs against one
    unsharded server on the card: states and counters bitwise, episodes
    equal, the reduced metrics by :func:`hold_reduced` (the ranks sum their
    slices), K1 512 times on each rank and held bitwise at [8192, 4] (twice
    a rank)."""
    from gym_collision_avoidance_torch.harness import paths

    ranks = [r["serving"] for r in results]
    path = serving_path("main")
    server = path.server(steps_per_dispatch=STEPS_PER_DISPATCH, device=DEVICE)
    for k in kernels.values():
        k.LAUNCHES = 0
    outs = [server.dispatch()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCHES - 1):
        outs.append(server.dispatch())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = DISPATCHES * STEPS_PER_DISPATCH
    check(kernels["pairwise"].LAUNCHES == total, "1 rank: K1 launch count")
    for r in ranks:
        check(r["launches"]["pairwise"] == total,
              f"a rank launched K1 {r['launches']['pairwise']} times in {total} steps")
        check(r["launches"]["raymarch"] == r["launches"]["laser_fused"] == 0,
              "a rank launched a laser kernel")
    held = check_held(ranks, "parallel_serving", [E_MAIN // PAR_RANKS, A_MAIN])
    differ = leaves_differ(joined(results, "serving", "states"), state_leaves(server.states()))
    check(not differ, f"parallel_serving: leaves {differ} differ from the 1-rank run")
    check(np.array_equal(joined(results, "serving", "counters"), server._counters.cpu().numpy()),
          "parallel_serving: counters differ")
    episodes = server.episodes_completed()
    check(all(r["episodes"] == episodes for r in ranks) and episodes > 0,
          f"parallel_serving: episodes {[r['episodes'] for r in ranks]} against {episodes}")
    worst = {}
    for d, want in enumerate(outs):
        for r in ranks:
            for k in ("mean_reward", "obs_checksum"):
                diff = hold_reduced(f"parallel_serving: {k}", r["outs"][d][k].numpy(),
                                    want[k].cpu().numpy())
                worst[k] = max(worst.get(k, 0.0), diff)
    timed = (DISPATCHES - 1) * STEPS_PER_DISPATCH
    slowest = max(r["seconds"] for r in ranks)
    line = {"num_envs": E_MAIN, "ranks": PAR_RANKS, "envs_per_rank": E_MAIN // PAR_RANKS,
            "steps": total, "timed_steps": timed, "states_and_counters_bitwise_equal": True,
            "episodes_completed": episodes, "metrics_max_abs_diff": worst,
            "k1_launches_per_rank": [r["launches"]["pairwise"] for r in ranks], **held,
            "env_steps_per_s_1_rank": timed * E_MAIN / seconds,
            "env_steps_per_s_2_ranks_sharing_one_card": timed * E_MAIN / slowest,
            "seconds_1_rank": seconds, "seconds_per_rank": [r["seconds"] for r in ranks]}
    print(json.dumps({"parallel_serving": line}), flush=True)
    return {f"parallel_serving_rank{i}": r["launches"] for i, r in enumerate(ranks)}


def row_count_effect(fn, whole, parts):
    """Whether ``fn`` of the row blocks ``parts`` of ``whole`` differs in any
    bit from the rows of ``fn(whole)`` (a library product may take another
    algorithm for fewer rows); and both results."""
    want, got = fn(whole), torch.cat([fn(x) for x in parts])
    return not bitwise_equal(want, got), want, got


def env_rows(state, parts):
    """``state`` cut into ``parts`` equal blocks of envs."""
    n = state.num_envs // parts
    return [state.map(lambda x, i=i: x[i * n:(i + 1) * n]) for i in range(parts)]


def phase_parallel_ga3c4(results):
    """One ga3c4 dispatch (E = 4096) on 2 ranks, the weights broadcast by
    ``replicate_global``, against one unsharded server.  States are held
    bitwise; if they differ, the GA3C net must give other bits for 2048 rows
    than for 4096 on the card (cuBLAS choosing by row count), and its
    actions on the final states agree under ``argmax_agreement``'s near-tie
    rule, on all but 1% of the envs."""
    from gym_collision_avoidance_torch.policies import ga3c

    path = serving_path("ga3c4")
    server = path.server(steps_per_dispatch=PAR_GA3C_STEPS, device=DEVICE)
    out = server.dispatch()
    want = state_leaves(server.states())
    got = joined(results, "ga3c4", "states")
    differ = leaves_differ(got, want)
    state = server.states()
    E, A = state.pos.shape[:2]
    effect, whole, pieces = row_count_effect(lambda st: ga3c.ga3c_cadrl_probs(st, path.params),
                                             state, env_rows(state, PAR_RANKS))
    _, line = argmax_agreement("ga3c4 rows", whole.cpu(), pieces.cpu(), 1e-5)
    envs_apart = int((got["pos"] != want["pos"]).any(axis=(1, 2)).sum())
    if differ:
        check(effect, f"parallel_ga3c4: leaves {differ} differ with no row-count effect")
        check(envs_apart <= E // 100, f"parallel_ga3c4: {envs_apart} envs apart")
    check(np.array_equal(joined(results, "ga3c4", "counters"), server._counters.cpu().numpy()),
          "parallel_ga3c4: counters differ")
    for r in results:
        hold_reduced("parallel_ga3c4: mean_reward", r["ga3c4"]["mean_reward"].numpy(),
                     out["mean_reward"].cpu().numpy())
        check(r["ga3c4"]["launches"]["pairwise"] == PAR_GA3C_STEPS, "parallel_ga3c4: K1 count")
    held = check_held([r["ga3c4"] for r in results], "parallel_ga3c4", [E // PAR_RANKS, A])
    print(json.dumps({"parallel_ga3c4": {
        "num_envs": E, "agents": A, "ranks": PAR_RANKS, "steps": PAR_GA3C_STEPS, **held,
        "states_bitwise_equal": not differ, "leaves_apart": differ, "envs_apart": envs_apart,
        "net_bits_depend_on_row_count": effect, "actions_on_final_states": line}}), flush=True)
    return {f"parallel_ga3c4_rank{i}": r["ga3c4"]["launches"] for i, r in enumerate(results)}


def phase_parallel_nccl(results):
    """``make_distributed_rollout`` of the same PAR_ROLLOUT_ENVS envs on a
    1-rank NCCL mesh and on the 2-rank gloo mesh: final states bitwise, done
    counts equal, mean rewards by :func:`hold_reduced` (a mean of 2 slice
    means against one mean); K1 PAR_ROLLOUT_STEPS times on every rank, held
    bitwise at [512, 4] on the gloo ranks and [1024, 4] on the NCCL one."""
    nccl, gloo = results["nccl"][0]["rollout"], results["gloo"]
    runs = {f"rollout_gloo_rank{i}": r["rollout"] for i, r in enumerate(gloo)}
    runs["rollout_nccl"] = nccl
    for name, r in runs.items():
        check(r["launches"]["pairwise"] == PAR_ROLLOUT_STEPS,
              f"{name}: K1 launched {r['launches']['pairwise']} times")
    held = {"gloo": check_held([r["rollout"] for r in gloo], "rollout over gloo",
                               [PAR_ROLLOUT_ENVS // PAR_RANKS, A_MAIN]),
            "nccl": check_held([nccl], "rollout over nccl", [PAR_ROLLOUT_ENVS, A_MAIN])}
    differ = leaves_differ(joined(gloo, "rollout", "states"), nccl["states"])
    check(not differ, f"parallel_nccl: leaves {differ} differ from the gloo run")
    for r in gloo:
        m = r["rollout"]["metrics"]
        check(torch.equal(m["done_count"], nccl["metrics"]["done_count"]),
              "parallel_nccl: done counts differ")
        hold_reduced("parallel_nccl: mean_reward", m["mean_reward"].numpy(),
                     nccl["metrics"]["mean_reward"].numpy())
    check(float(nccl["metrics"]["done_count"].sum()) > 0, "parallel_nccl: no episode ended")
    print(json.dumps({"parallel_nccl": {
        "num_envs": PAR_ROLLOUT_ENVS, "steps": PAR_ROLLOUT_STEPS, "backend": "nccl",
        "states_bitwise_equal_to_gloo": True, "k1_held": held,
        "k1_launches": {name: r["launches"]["pairwise"] for name, r in runs.items()},
        "done_count": float(nccl["metrics"]["done_count"].sum()),
        "mean_reward_max_abs_diff": max(float((r["rollout"]["metrics"]["mean_reward"]
                                               - nccl["metrics"]["mean_reward"]).abs().max())
                                        for r in gloo)}}), flush=True)
    return {name: r["launches"] for name, r in runs.items()}


def blockwise_mlp(trainer, parts):
    """Make ``trainer``'s MLP evaluate its rows in ``parts`` equal blocks, as
    ``parts`` ranks each evaluate their own."""
    apply = trainer.family.net_apply

    def net_apply(params, x):
        outs = [apply(params, block) for block in x.chunk(parts)]
        mean = torch.cat([o[0][0] for o in outs])
        return (mean, outs[0][0][1]), torch.cat([o[1] for o in outs])

    trainer.family.net_apply = net_apply
    return trainer


def phase_sharded_ppo(results):
    """train_mlp2 (E = 1024, T = 64, 2 agents against RVO) on 2 ranks against
    1 rank on the card, from ``init_fn``'s carry and one seed, 1 epoch x 1
    minibatch.  Env states are held bitwise and counters equal against a
    1-rank run whose MLP evaluates its rows in the ranks' two blocks
    (:func:`blockwise_mlp`; cuBLAS may take another algorithm for 512 rows
    than for 1024, and then an action an ulp apart moves a state) and whose
    loss is the ranks' mean loss (:func:`ranks_loss`); params within
    SHARDED_PARAMS_ATOL of it, and the gradients the ranks applied within
    SHARDED_GRADS_RTOL of each tensor's largest entry (Adam's first step is
    about ``lr * sign(g)``, so only the gradients show their scale).  Whether
    the MLP's bits depend on the row count, and the plain 1-rank run's
    distance, are reported; K1 is held at [512, 2] on each rank.  Then the 2
    ranks' timed 4 x 4 iteration."""
    from gym_collision_avoidance_torch import convert
    from gym_collision_avoidance_torch.train import PPOTrainer

    path, ppo1 = sharded_mlp2()
    runs = {}
    for name in ("one_rank", "one_rank_ranks_loss"):
        trainer = PPOTrainer(ppo1, pool=path.pool, device=DEVICE)
        params, opt, states, counters, obs = trainer.init_fn(ppo1.seed)
        grads = record_grads(trainer)
        if name == "one_rank":
            x = trainer.flatten_ego(obs)
            effect, _, _ = row_count_effect(lambda r: trainer.family.net_apply(params, r)[0][0],
                                            x, x.chunk(PAR_RANKS))
        else:
            blockwise_mlp(trainer, PAR_RANKS)
            perm = trainer.sample_noise(torch.Generator(DEVICE).manual_seed(7))["perm"][0]
            ranks_loss(trainer, perm, PAR_RANKS)
        out = trainer.train_step(params, opt, states, counters, obs,
                                 rng=torch.Generator(DEVICE).manual_seed(7))
        runs[name] = {"states": state_leaves(out[2]), "counters": out[3].cpu().numpy(),
                      "params": convert.ppo_params_to_numpy("mlp", out[0]), "grads": grads[0]}
    got = joined(results, "sharded_ppo", "states")
    counters = joined(results, "sharded_ppo", "counters")
    mine = results[0]["sharded_ppo"]["params"]
    (applied,) = results[0]["sharded_ppo"]["grads"]
    report = {}
    for name, run in runs.items():
        report[name] = {
            "grads_max_diff_over_largest": max(
                float(np.max(np.abs(applied[k] - g)) / np.max(np.abs(g)))
                for k, g in run["grads"].items()),
            "leaves_apart": leaves_differ(got, run["states"]),
            "counters_equal": bool(np.array_equal(counters, run["counters"])),
            "state_max_abs_diff": {k: float(np.max(np.abs(got[k].astype(np.float64)
                                                          - run["states"][k])))
                                   for k in ("pos", "vel", "heading", "speed")},
            "params_max_abs_diff": max(float(np.max(np.abs(mine[k] - run["params"][k])))
                                       for k in mine)}
    held = "one_rank_ranks_loss"
    check(not report[held]["leaves_apart"],
          f"sharded_ppo: leaves {report[held]['leaves_apart']} differ from the {held} run")
    check(report[held]["counters_equal"], f"sharded_ppo: counters differ from the {held} run")
    check(report[held]["params_max_abs_diff"] <= SHARDED_PARAMS_ATOL,
          f"sharded_ppo: params apart from the {held} run: {report[held]}")
    check(report[held]["grads_max_diff_over_largest"] <= SHARDED_GRADS_RTOL,
          f"sharded_ppo: gradients apart from the {held} run: {report[held]}")
    for r in results[1:]:
        check(all(np.array_equal(r["sharded_ppo"]["params"][k], mine[k]) for k in mine),
              "sharded_ppo: the replicas' params differ")
    timed = [r["sharded_ppo"] for r in results]
    k1_held = check_held(timed, "sharded_ppo", [path.ppo.num_envs // PAR_RANKS, 2])
    T, E = path.ppo.horizon, path.ppo.num_envs
    slowest = max(t["seconds"] for t in timed)
    for t in timed:
        check(t["launches"]["pairwise"] == T, f"sharded_ppo: K1 launched {t['launches']}")
        finite_metrics("sharded_ppo", t["metrics4"])
    print(json.dumps({"sharded_ppo": {
        "num_envs": E, "ranks": PAR_RANKS, "horizon": T,
        "one_minibatch_step": {"net_bits_depend_on_row_count": effect, "held_against": held,
                               **report, **k1_held},
        "iteration_4x4": {"seconds_per_rank": [t["seconds"] for t in timed],
                          "env_steps_per_s_2_ranks_sharing_one_card": E * T / slowest,
                          "phase_ms_rank0": {k: 1e3 * v for k, v in timed[0]["timings"].items()},
                          "k1_launches_per_rank": [t["launches"]["pairwise"] for t in timed]}}}),
          flush=True)
    return {f"sharded_ppo_rank{i}": t["launches"] for i, t in enumerate(timed)}


def phase_sharded_resume(results):
    """``train_ppo_torch.py --save/--resume`` under a mesh
    (:func:`rank_sharded_resume`) on 2 gloo ranks sharing the card and on 1
    NCCL rank: 2 iterations bitwise equal, in every leaf of the saved carry
    and generator, to 1 iteration, a save, a resume and 1 more; K1 twice
    the horizon a rank in the 2 iterations, held at ``[E / D, 2]``."""
    from gym_collision_avoidance_torch.harness import paths

    ppo = paths.training_path("train_mlp2").ppo
    line, by_path = {"device": nvidia_smi_line(), "num_envs": ppo.num_envs,
                     "horizon": ppo.horizon, "iterations": 2}, {}
    for label, ranks in results.items():
        runs = [r["sharded_resume"] for r in ranks]
        for i, r in enumerate(runs):
            check(r["launches"]["pairwise"] == 2 * ppo.horizon,
                  f"sharded_resume over {label}: rank {i} launched K1 {r['launches']}")
            by_path[f"sharded_resume_{label}_rank{i}"] = r["launches"]
        check(runs[0]["leaves"] > 0 and not runs[0]["leaves_apart"],
              f"sharded_resume over {label}: leaves {runs[0]['leaves_apart']} of the resumed "
              "run differ from the uninterrupted one")
        line[label] = {"ranks": len(runs), "leaves_bitwise_equal": runs[0]["leaves"],
                       "file_bytes": runs[0]["file_bytes"],
                       "seconds_two_iterations": [r["seconds_two_iterations"] for r in runs],
                       "case_seconds": [r["case_seconds"] for r in runs],
                       **check_held(runs, f"sharded_resume over {label}",
                                    [ppo.num_envs // len(runs), 2])}
    print(json.dumps({"sharded_resume": line}), flush=True)
    return by_path


# the scaling phase's sizes: scripts/scaling_bench_torch.py, collective_overhead_torch.py
# and scaling_multiproc_torch.py cut to fit its 90 s of card time
SCALE_BENCH = ["--envs-per-device", "16", "--steps", "8", "--reps", "1"]
SCALE_COLLECTIVES = ["--envs", "1024", "--steps", "16", "--ppo-envs", "64", "--calls", "32",
                     "--reps", "1"]
MULTIPROC_STEPS, MULTIPROC_REPS = 16, 1
SCALE_MULTIPROC = ["--ranks", "1", "--envs", "128", "--steps", str(MULTIPROC_STEPS),
                   "--reps", str(MULTIPROC_REPS)]
DRYRUN_K1 = 2 + 2 + 2 + 2 * 32    # the step twice, the rollout, PPO's horizon, 2 dispatches


def phase_scaling(results, kernels):
    """The JAX repo's multi-device entry points as the port runs them, each
    rank's kernel launches counted from 0:

    * ``entry.entry()``: one step of 8 GA3C-CADRL envs on the card (K1 once,
      held bitwise), against the same step on the CPU;
    * ``entry.dryrun_multichip(1)`` over NCCL and ``(2, backend="gloo")`` with
      the ranks sharing the card: K1 DRYRUN_K1 times a rank, episodes served;
      its rank body inside the ``--rank-job`` runs, K1 held bitwise at [2, 4]
      on every rank;
    * ``scripts/scaling_bench_torch.py`` at 1 NCCL rank and at 1-2 gloo ranks,
      K1 once a step of every table on every rank;
    * ``scripts/collective_overhead_torch.py`` on 2 gloo ranks (its recorded
      all-reduces equal to its accounting, or it raises);
    * ``scripts/scaling_multiproc_torch.py``: 1 rank over gloo and over NCCL
      (checksums equal) and the weak point at 2 gloo ranks.

    Ranks that share the card measure the collectives' overhead, not
    scaling; every number is printed with the card's ``nvidia-smi`` line."""
    import tempfile

    from gym_collision_avoidance_torch import entry
    from gym_collision_avoidance_torch.ops import pairwise

    smi = nvidia_smi_line()
    one_backend = "nccl" if DEVICE == "cuda" else "gloo"
    note = "ranks that share the card: the collectives' overhead, not scaling"
    line, by_path = {"device": smi, "note": note}, {}

    # entry(): one step on the card, K1 held, against the CPU's step
    fn, args = entry.entry(device=DEVICE)
    zero_counts(kernels)
    calls, outs = [], []
    t0 = time.perf_counter()
    with capture(pairwise, "pairwise_rewards_cuda", calls, outs):
        states, rew, game_over = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    by_path["entry"] = rank_counts(kernels)
    check(by_path["entry"]["pairwise"] == 1 and len(calls) == 1,
          f"entry: K1 {by_path['entry']}")
    err = hold_k1(pairwise.pairwise_rewards_plain, calls[0], outs[0], "entry")
    cpu_fn, cpu_args = entry.entry(device="cpu")
    cpu_states, cpu_rew, cpu_go = cpu_fn(*cpu_args)
    check(tuple(rew.shape) == (8, 4) and bool(torch.isfinite(rew).all()), "entry: rewards")
    check(torch.equal(game_over.cpu(), cpu_go), "entry: game_over differs from the CPU's")
    for name, got, want in (("rewards", rew, cpu_rew), ("pos", states.pos, cpu_states.pos),
                            ("vel", states.vel, cpu_states.vel)):
        check(torch.allclose(got.cpu(), want, **METRICS_TOL),
              f"entry: {name} apart from the CPU's by {max_abs_err(got.cpu(), want)}")
    line["entry"] = {"num_envs": 8, "agents": 4, "ms": 1e3 * seconds, "k1_held_max_abs_err": err,
                     "max_abs_diff_to_cpu": max(max_abs_err(rew.cpu(), cpu_rew),
                                                max_abs_err(states.pos.cpu(), cpu_states.pos))}

    # dryrun_multichip, as a user calls it, both runs at once (their ranks
    # start together); its rank body is held in the rank jobs
    def dryrun(n, backend):
        t0 = time.perf_counter()
        return entry.dryrun_multichip(n, device=DEVICE, backend=backend), \
            time.perf_counter() - t0

    runs = ((one_backend, 1, None), ("gloo", PAR_RANKS, "gloo"))
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        done = [pool.submit(dryrun, n, backend) for _label, n, backend in runs]
    line["dryrun"] = {}
    for (label, n, _backend), job in zip(runs, done):
        ranks, seconds = job.result()
        for r in ranks:
            check((r["backend"], r["size"]) == (label, n), f"dryrun: {r['backend']} x {r['size']}")
            check(r["launches"]["pairwise"] == DRYRUN_K1 and r["episodes"] > 0,
                  f"dryrun over {label}: rank {r['rank']} K1 {r['launches']}, "
                  f"{r['episodes']} episodes")
            by_path[f"dryrun_{label}_rank{r['rank']}"] = r["launches"]
        line["dryrun"][label] = {"ranks": n, "seconds": seconds,
                                 "rank_seconds": [r["seconds"] for r in ranks],
                                 "episodes": ranks[0]["episodes"]}
    for label, ranks in results.items():
        runs = [r["dryrun"] for r in ranks]
        for i, r in enumerate(runs):
            check(r["launches"]["pairwise"] == DRYRUN_K1,
                  f"dryrun rank job over {label}: rank {i} K1 {r['launches']}")
        line["dryrun"][f"{label}_rank_job"] = check_held(runs, f"dryrun over {label}", [2, 4])

    # the three scripts at small sizes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scaling_") as tmp:
        bench = script_module("scaling_bench_torch")
        line["scaling_bench"] = {}
        for label, argv in ((one_backend, ["--max-ranks", "1"]),
                            ("gloo", ["--backend", "gloo", "--max-ranks", str(PAR_RANKS)])):
            t0 = time.perf_counter()
            r = bench.run(bench.parse_args(argv + SCALE_BENCH + [
                "--device", DEVICE, "--out", os.path.join(tmp, f"{label}.md")]))
            reps, S = r["reps"], r["steps"]
            want = {"rollout_weak": reps * S, "rollout_fixed": reps * S,
                    "serving_weak": (1 + 4 * reps) * S, "serving_fixed": (1 + 4 * reps) * S,
                    "ppo": (1 + reps) * r["ppo_horizon"]}
            for n, per_rank in r["launches_by_rank"].items():
                for i, tables in enumerate(per_rank):
                    got = {k: t["pairwise"] for k, t in tables.items()}
                    check(got == want, f"scaling_bench over {label}, {n} ranks, rank {i}: K1 "
                                       f"{got}, not {want}")
                    by_path[f"scaling_bench_{label}_{n}ranks_rank{i}"] = {
                        k: sum(t[k] for t in tables.values()) for k in kernels}
            line["scaling_bench"][label] = {"seconds": time.perf_counter() - t0,
                                            "platform": r["platform"], "tables": r["tables"]}
        collectives = script_module("collective_overhead_torch")
        t0 = time.perf_counter()
        r = collectives.run(collectives.parse_args(
            ["--device", DEVICE, "--backend", "gloo", "--ranks", str(PAR_RANKS)]
            + SCALE_COLLECTIVES))
        for v in r["ppo"]:
            check(v["warm_up_launches"]["pairwise"] == 16, f"collective_overhead: K1 {v}")
        line["collective_overhead"] = {
            "seconds": time.perf_counter() - t0,
            **{k: r[k] for k in ("backend", "ranks", "traffic", "recorded", "chains", "ppo",
                                 "overhead_s", "predicted_overhead_s", "one_rank",
                                 "projection")}}
        by_path["collective_overhead_rank0"] = r["ppo"][0]["warm_up_launches"]
        multiproc = script_module("scaling_multiproc_torch")
        t0 = time.perf_counter()
        r = multiproc.run(multiproc.parse_args(["--device", DEVICE] + SCALE_MULTIPROC))
        check(r["fixed_checksums_identical"], f"scaling_multiproc: checksums {r}")
        for name, point in r.items():
            if isinstance(point, dict) and "launches_by_rank" in point:
                for i, counts in enumerate(point["launches_by_rank"]):
                    check(counts["pairwise"] == (1 + MULTIPROC_REPS) * MULTIPROC_STEPS,
                          f"scaling_multiproc {name}: rank {i} K1 {counts}")
                    by_path[f"scaling_multiproc_{name}_rank{i}"] = counts
        line["scaling_multiproc"] = {"seconds": time.perf_counter() - t0, **r}
    print(json.dumps({"scaling": line}), flush=True)
    return by_path


def phase_strict_parity(kernels):
    """STRICT_STEPS auto-reset steps of the main path at E = STRICT_ENVS with
    ``strict_parity=True`` on the card against the CPU: pos, heading, vel and
    speed bitwise equal (both compute atan2 and the dynamics on the host)."""
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer

    path = serving_path("main")
    cfg = path.cfg.replace(strict_parity=True)
    servers = {d: AutoresetServer(cfg, path.pool, path.policy_id, num_envs=STRICT_ENVS,
                                  steps_per_dispatch=STRICT_STEPS, device=d)
               for d in (DEVICE, "cpu")}
    for k in kernels.values():
        k.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    servers[DEVICE].dispatch()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rank_counts(kernels)
    servers["cpu"].dispatch()
    card, cpu = (state_leaves(servers[d].states()) for d in (DEVICE, "cpu"))
    differ = leaves_differ(card, cpu)
    check(not {"pos", "heading", "vel", "speed"} & set(differ),
          f"strict_parity: {differ} differ between the card and the CPU")
    check(launches["pairwise"] == STRICT_STEPS, f"strict_parity: K1 {launches}")
    check(servers["cpu"].episodes_completed() > 0, "strict_parity: no episode completed")
    print(json.dumps({"strict_parity": {
        "num_envs": STRICT_ENVS, "steps": STRICT_STEPS, "pos_heading_vel_speed_bitwise": True,
        "other_leaves_apart": differ, "episodes_completed": servers["cpu"].episodes_completed(),
        "ms_per_step": 1e3 * seconds / STRICT_STEPS}}), flush=True)
    return {"strict_parity": launches}


def main():
    if "--rank-job" in sys.argv:
        return rank_main(sys.argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    from gym_collision_avoidance_torch.ops import (build, cadrl_value, drl_long_conv,
                                                   laser_fused, pairwise, raymarch)

    smi = nvidia_smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)
    kernels = {"pairwise": pairwise, "raymarch": raymarch, "laser_fused": laser_fused}

    def run(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(json.dumps({"phase_seconds": {name: time.perf_counter() - t0}}), flush=True)
        return out

    run("build", phase_build, build)
    k1 = run("kernels_k1", phase_kernels, pairwise)
    k2 = run("kernels_k2", phase_k2)
    k3 = run("kernels_k3", phase_k3)
    for k in (k2, k3):
        k["launch_floor_ms"] = k1["launch_floor_ms"]
    by_path = {}
    for name, label in (("main", "serving"), ("ga3c4", "ga3c4_serving"),
                        ("orca4", "orca4_serving")):
        by_path[name], _ = run(label, phase_serving, label, kernels, serving_path(name))
    k4 = run("kernels_cadrl_value", phase_cadrl_value)
    k5 = run("kernels_drl_long_conv", phase_drl_long_conv)
    k5["launch_floor_ms"] = k1["launch_floor_ms"]
    for name in ("cadrl4", "drl2"):
        cadrl_value.LAUNCHES = drl_long_conv.LAUNCHES = 0
        by_path[name], _ = run(f"{name}_serving", phase_serving, f"{name}_serving", kernels,
                               serving_path(name),
                               laser="raymarch" if name == "drl2" else None,
                               steps=POLICY_STEPS, dispatches=POLICY_DISPATCHES)
        steps = (POLICY_DISPATCHES + 1) * POLICY_STEPS
        want = {"cadrl_value": steps if name == "cadrl4" else 0,
                "drl_long_conv": steps if name == "drl2" else 0}
        got = {"cadrl_value": cadrl_value.LAUNCHES, "drl_long_conv": drl_long_conv.LAUNCHES}
        check(got == want, f"{name}: the policy kernels launched {got}, not {want}")
        by_path[name] = dict(by_path[name], **got)
    run("reward_ab", phase_reward_ab, pairwise)
    run("card_vs_cpu", phase_card_vs_cpu)
    run("policy_card_vs_cpu", phase_policy_card_vs_cpu)
    run("networks", phase_networks)
    by_path["laser_full"], states = run("laser_serving_full", phase_serving,
                                        "laser_serving_full", kernels,
                                        serving_path("laser_full"), "raymarch",
                                        LASER_STEPS, LASER_DISPATCHES)
    by_path["laser_fast"], _ = run("laser_serving_fast", phase_serving, "laser_serving_fast",
                                   kernels, serving_path("laser_fast"), "laser_fused",
                                   LASER_STEPS, LASER_DISPATCHES)
    run("fast_vs_full", phase_fast_vs_full, states)
    run("laser_card_vs_cpu", phase_laser_card_vs_cpu)
    profiler = script_module("profile_torch_serving")
    trained = {}
    for name in TRAIN_ITERS:
        by_path[name], trained[name] = run(name, phase_training, name, kernels, profiler)
    run("kernels_on_training", phase_kernels_on_training)
    run("train_card_vs_cpu", phase_train_card_vs_cpu)
    run("train_deterministic", phase_train_deterministic)
    by_path.update(run("suite_4agent", phase_suite_4agent, kernels))
    run("suite_controls", phase_suite_controls)
    run("suite_k1", phase_suite_k1)
    run("gymapi", phase_gymapi)
    ranks = run("parallel_ranks", phase_parallel_ranks)
    by_path.update(run("parallel_serving", phase_parallel_serving, ranks["gloo"], kernels))
    by_path.update(run("parallel_ga3c4", phase_parallel_ga3c4, ranks["gloo"]))
    by_path.update(run("parallel_nccl", phase_parallel_nccl, ranks))
    by_path.update(run("sharded_ppo", phase_sharded_ppo, ranks["gloo"]))
    by_path.update(run("sharded_resume", phase_sharded_resume, ranks))
    by_path.update(run("scaling", phase_scaling, ranks, kernels))
    by_path.update(run("strict_parity", phase_strict_parity, kernels))
    drl_long_conv.LAUNCHES = 0
    by_path.update(run("eval_drl_long", phase_eval_drl_long, kernels))
    check(drl_long_conv.LAUNCHES == by_path["eval_drl_long"]["pairwise"],
          f"eval_drl_long: the convolution kernel launched {drl_long_conv.LAUNCHES} times, "
          f"not once a step")
    by_path["eval_drl_long"] = dict(by_path["eval_drl_long"],
                                    drl_long_conv=drl_long_conv.LAUNCHES)
    by_path.update(run("eval_trained_net", phase_eval_trained_net, kernels,
                       trained["train_ga3c4"]))
    by_path.update(run("reinforce", phase_reinforce, kernels))
    by_path.update(run("bench_rows", phase_bench_rows, kernels))

    for k, name, main_path in ((k1, "pairwise", "main"), (k2, "raymarch", "laser_full"),
                               (k3, "laser_fused", "laser_fast")):
        k["launches"] = by_path[main_path][name]
        k["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
    k4["launches"] = by_path["cadrl4"]["cadrl_value"]
    k5["launches"] = by_path["drl2"]["drl_long_conv"]
    k5["launches_by_path"] = {path: counts["drl_long_conv"] for path, counts in by_path.items()
                              if "drl_long_conv" in counts}
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
