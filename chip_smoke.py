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
graph.  Then it drives the port's paths
through ``AutoresetServer``, each with the kernel launch counts set to 0 just
before and read just after:

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

import contextlib
import copy
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
KERNEL_SOURCES = ("pairwise", "raymarch", "laser_fused")
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


def hold_k1(pairwise, args, coll, near, what):
    """K1's outputs ``coll, near`` on ``args`` against its plain version:
    collision flags equal, nearest gaps bitwise equal (NaN where it has
    NaN); returns the largest gap difference."""
    ref_coll, ref_near = pairwise.pairwise_collisions_plain(*args)
    check(torch.equal(coll, ref_coll), f"K1 collision flags differ ({what})")
    finite = ~torch.isnan(ref_near)
    check(torch.equal(torch.isnan(near), ~finite), f"K1 NaN pattern differs ({what})")
    itype = torch.int32 if near.dtype == torch.float32 else torch.int64
    check(torch.equal(near[finite].view(itype), ref_near[finite].view(itype)),
          f"K1 nearest gaps not bitwise equal ({what})")
    return max_abs_err(near, ref_near)


def phase_kernels(pairwise):
    """Hold K1 bitwise against the plain version; time both at the main
    path's shape, on the device (CUDA graph replay) and as eager calls."""
    worst = 0.0
    cases = [(torch.float32, E_MAIN, A_MAIN, False), (torch.float32, 512, 40, False),
             (torch.float64, 64, 4, False), (torch.float32, 64, 4, True)]
    for dtype, E, A, nan in cases:
        args = pairwise_inputs(7, E, A, dtype, DEVICE, nan)
        coll, near = pairwise.pairwise_collisions(*args)
        torch.cuda.synchronize()
        worst = max(worst, hold_k1(pairwise, args, coll, near, f"{dtype} E={E} A={A} nan={nan}"))
        if not nan:
            touching = args[2][::4, 0] & args[2][::4, 1]
            check(bool(coll[::4, 0][touching].all()), "touching pairs must collide")
        print(f"K1 {str(dtype)[6:]} E={E} A={A} nan={nan}: bitwise equal", flush=True)

    pos, radius, valid = pairwise_inputs(8, E_MAIN, A_MAIN, torch.float32, DEVICE)
    kernel = lambda: pairwise.pairwise_collisions_cuda(pos, radius, valid)  # noqa: E731
    plain = lambda: pairwise.pairwise_collisions_plain(pos, radius, valid)  # noqa: E731
    ms, plain_ms = graph_ms(kernel), graph_ms(plain)
    # the least one launch costs: a fill of K1's output bytes, in a graph
    floor_buf = torch.empty(E_MAIN * A_MAIN * 5, dtype=torch.uint8, device=DEVICE)
    launch_floor_ms = graph_ms(lambda: floor_buf.fill_(0))
    # the same calls issued eagerly, host overhead included
    eager_ms, plain_eager_ms = median_ms(kernel), median_ms(plain)
    coll, near = pairwise.pairwise_collisions_plain(pos, radius, valid)
    moved = sum(t.numel() * t.element_size() for t in (pos, radius, valid, coll, near))
    # per valid ordered pair: 2 sub, 2 mul, add, sqrt, add, sub, 2 compares
    n = valid.sum(dim=1)
    ops = 10 * float((n * (n - 1)).sum())
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations"
    summary = {"kernel": "pairwise_collisions", "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "library_ms": None, "launches_per_step": 1,
               "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
               "launch_floor_ms": launch_floor_ms}
    print(json.dumps(summary), flush=True)
    return {"name": "pairwise_collisions", "route": "cuda",
            "source": "gym_collision_avoidance_torch/csrc/pairwise.cu",
            "replaces": "gym_collision_avoidance_tpu/ops/pairwise.py:77",
            "launches": None, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "launch_floor_ms": launch_floor_ms}


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


# ---------------------------------------------------------------- laser path

@contextlib.contextmanager
def capture(module, name, calls, outs=None):
    """Record the arguments of every call of ``module.name`` in ``calls``,
    and its results in ``outs`` if given."""
    orig = getattr(module, name)

    def spy(*args):
        calls.append(args)
        out = orig(*args)
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


def profiler_module():
    """``scripts/profile_torch_serving.py``, whose ``trace_iteration``
    traces one PPO iteration."""
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "profile_torch_serving", os.path.join(root, "scripts", "profile_torch_serving.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
    never."""
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
    return launches


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
        with capture(pairwise, "pairwise_collisions_cuda", k1_calls, k1_outs), \
                capture(raymarch, "raymarch_cuda", k2_calls, k2_outs):
            trainer.rollout(params, states, counters, obs, noise)
        torch.cuda.synchronize()
        check(len(k1_calls) == TRAIN_CHECK_STEPS,
              f"{name}: {TRAIN_CHECK_STEPS} rollout steps launched K1 {len(k1_calls)} times")
        for t, (args, (coll, near)) in enumerate(zip(k1_calls, k1_outs)):
            hold_k1(pairwise, args, coll, near, f"{name} rollout step {t}")
        line = {"k1_shape": list(k1_calls[0][0].shape), "k1_steps": len(k1_calls),
                "k1_bitwise_equal": True,
                "k1_colliding": int(sum(int(c.sum()) for c, _ in k1_outs))}
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    from gym_collision_avoidance_torch.ops import build, laser_fused, pairwise, raymarch

    smi = nvidia_smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)
    kernels = {"pairwise": pairwise, "raymarch": raymarch, "laser_fused": laser_fused}

    phase_build(build)
    k1 = phase_kernels(pairwise)
    k2 = phase_k2()
    k3 = phase_k3()
    for k in (k2, k3):
        k["launch_floor_ms"] = k1["launch_floor_ms"]
    by_path = {}
    for name, label in (("main", "serving"), ("ga3c4", "ga3c4_serving"),
                        ("orca4", "orca4_serving")):
        by_path[name], _ = phase_serving(label, kernels, serving_path(name))
    for name in ("cadrl4", "drl2"):
        by_path[name], _ = phase_serving(f"{name}_serving", kernels, serving_path(name),
                                         laser="raymarch" if name == "drl2" else None,
                                         steps=POLICY_STEPS, dispatches=POLICY_DISPATCHES)
    phase_card_vs_cpu()
    phase_policy_card_vs_cpu()
    phase_networks()
    by_path["laser_full"], states = phase_serving("laser_serving_full", kernels,
                                                  serving_path("laser_full"), "raymarch",
                                                  LASER_STEPS, LASER_DISPATCHES)
    by_path["laser_fast"], _ = phase_serving("laser_serving_fast", kernels,
                                             serving_path("laser_fast"), "laser_fused",
                                             LASER_STEPS, LASER_DISPATCHES)
    phase_fast_vs_full(states)
    phase_laser_card_vs_cpu()
    profiler = profiler_module()
    for name in TRAIN_ITERS:
        by_path[name] = phase_training(name, kernels, profiler)
    phase_kernels_on_training()
    phase_train_card_vs_cpu()
    phase_train_deterministic()

    for k, name, main_path in ((k1, "pairwise", "main"), (k2, "raymarch", "laser_full"),
                               (k3, "laser_fused", "laser_fast")):
        k["launches"] = by_path[main_path][name]
        k["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
