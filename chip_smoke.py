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
  windows and 4 beam slots (kernels K1 and K3).

It checks the fast route against the full pass wherever its exactness guard
is quiet, and one env step on the card against the same step on the CPU:
on the main path, on ga3c4 and orca4 (GA3C action indices, ORCA
velocities and LP branches) and on both laser routes.  Every phase raises
on failure, so the exit code is 0 only if all passed.  The last three lines
of its output are the kernels' JSON summary (with each kernel's launches on
every path), the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  It imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
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
E_MAIN, A_MAIN = 16384, 4
STEPS_PER_DISPATCH, DISPATCHES = 128, 4
# scripts/bench_all.py: bench_ga3c4_serving runs 16384 // 4 envs, bench_orca4 16384
E_GA3C4, E_ORCA4 = 4096, 16384
# the laser path (scripts/bench_all.py:bench_ga3c20_laser: 4096 // 16 envs)
E_LASER, A_LASER, L_LASER = 256, 20, 512
LASER_STEPS, LASER_DISPATCHES = 64, 4
KERNEL_SOURCES = ("pairwise", "raymarch", "laser_fused")


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
        ref_coll, ref_near = pairwise.pairwise_collisions_plain(*args)
        check(torch.equal(coll, ref_coll), f"collision flags differ {dtype} E={E} A={A}")
        finite = ~torch.isnan(ref_near)
        check(torch.equal(torch.isnan(near), ~finite), "NaN pattern differs")
        itype = torch.int32 if dtype == torch.float32 else torch.int64
        check(torch.equal(near[finite].view(itype), ref_near[finite].view(itype)),
              f"nearest gaps not bitwise equal {dtype} E={E} A={A} nan={nan}")
        if not nan:
            touching = args[2][::4, 0] & args[2][::4, 1]
            check(bool(coll[::4, 0][touching].all()), "touching pairs must collide")
        worst = max(worst, max_abs_err(near, ref_near))
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


def main_path_config():
    from gym_collision_avoidance_torch import EnvConfig
    from gym_collision_avoidance_torch.policies import registry
    from gym_collision_avoidance_torch.scenarios import random_cases

    # the loop bench.py:_bench_serving times
    cfg = EnvConfig(dtype="float32", done_mode="evaluate")
    pool = random_cases.scenario_pool(64, A_MAIN, seed=0, side_length=4.0)
    policy_id = np.full(A_MAIN, registry.NONCOOP, np.int32)
    return cfg, pool, policy_id


def ga3c4_config():
    """``scripts/bench_all.py:bench_ga3c4_serving``: 4 GA3C-CADRL agents with
    the iros18 weights, 19 observed slots sorted closest last."""
    from gym_collision_avoidance_torch import EnvConfig
    from gym_collision_avoidance_torch.models import ga3c_cadrl
    from gym_collision_avoidance_torch.policies import registry
    from gym_collision_avoidance_torch.scenarios import random_cases

    cfg = EnvConfig(dtype="float32", done_mode="evaluate", max_num_other_agents_observed=19,
                    agent_sorting_method="closest_last")
    pool = random_cases.scenario_pool(64, A_MAIN, seed=0, side_length=4.0)
    params = {"ga3c_cadrl": ga3c_cadrl.load_params(device=DEVICE)}
    return cfg, pool, np.full(A_MAIN, registry.GA3C_CADRL, np.int32), params


def orca4_config():
    """``scripts/bench_all.py:bench_orca4``: 4 RVO agents."""
    from gym_collision_avoidance_torch.policies import registry

    cfg, pool, _ = main_path_config()
    return cfg, pool, np.full(A_MAIN, registry.RVO, np.int32), None


def phase_serving(name, kernels, cfg, pool, policy_id, params, num_envs):
    """Drive AutoresetServer at ``num_envs``; the counts go to 0 after
    construction, and K1 must launch once per step and no laser kernel."""
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer

    server = AutoresetServer(cfg, pool, policy_id, num_envs=num_envs, params=params,
                             steps_per_dispatch=STEPS_PER_DISPATCH, device=DEVICE)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.LAUNCHES = 0
    server.dispatch()                                   # warm-up dispatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCHES):
        out = server.dispatch()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: k.LAUNCHES for n, k in kernels.items()}
    steps = (DISPATCHES + 1) * STEPS_PER_DISPATCH
    check(launches["pairwise"] == steps,
          f"{name}: K1 launched {launches['pairwise']} times in {steps} steps")
    check(launches["raymarch"] == 0 and launches["laser_fused"] == 0,
          f"{name}: a laser kernel launched")

    for leaf_name, leaf in server.states().items():
        if leaf.is_floating_point():
            check(bool(torch.isfinite(leaf).all()), f"{name}: non-finite state leaf {leaf_name}")
    check(bool(torch.isfinite(out["mean_reward"]).all()), f"{name}: non-finite reward")
    episodes = server.episodes_completed()
    check(episodes > 0, f"{name}: no episode completed")
    timed = DISPATCHES * STEPS_PER_DISPATCH
    line = {"num_envs": num_envs, "agents": A_MAIN, "steps": steps, "timed_steps": timed,
            "seconds": seconds, "env_steps_per_s": timed * num_envs / seconds,
            "ms_per_step": 1e3 * seconds / timed, "episodes_completed": episodes,
            "k1_launches": launches["pairwise"]}
    print(json.dumps({name: line}), flush=True)
    return launches["pairwise"], server.states()


def compare_steps(name, cpu, card, rtol, atol, envs=None, slack=None):
    """Hold one ``env_step``'s outputs on the card against the CPU's, on the
    envs of the ``[E]`` mask ``envs`` (all by default): discrete outputs
    equal, floats within ``rtol`` / ``atol``, plus ``slack[leaf]`` (a tensor
    of the leaf's shape) where given.  Returns the largest float difference
    and the count of entries that needed their slack."""
    pairs = [(f"state.{k}", v, getattr(card[0], k)) for k, v in cpu[0].items()]
    pairs += [(f"obs.{k}", v, card[1][k]) for k, v in cpu[1].items()]
    pairs += [("rewards", cpu[2], card[2]), ("game_over", cpu[3], card[3])]
    pairs += [(f"info.{k}", v, card[4][k]) for k, v in cpu[4].items()]
    slack = slack or {}
    worst, slackened = 0.0, 0
    for leaf, want, got in pairs:
        got = got.cpu()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name} {leaf} shape/dtype")
        extra = slack.get(leaf)
        if envs is not None:
            got, want = got[envs], want[envs]
            extra = None if extra is None else extra[envs]
        if want.is_floating_point():
            close = torch.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
            if extra is not None:
                loose = (got - want).abs() <= atol + rtol * want.abs() + extra
                slackened += int((loose & ~close).sum())
                close |= loose
            bad = int((~close).reshape(len(close), -1).any(dim=1).sum()) if close.dim() else 0
            check(bool(close.all()), f"{name} {leaf} differs beyond rtol {rtol} / atol {atol} "
                  f"in {bad} envs, by up to {max_abs_err(got, want)}")
            worst = max(worst, max_abs_err(got, want))
        else:
            check(torch.equal(got, want), f"{name} {leaf} differs")
    return worst, slackened


def goal_frame_slack(cpu, card):
    """Extra absolute tolerance for the outputs an agent sees in its goal
    frame (``ref_prll``, ``ref_orth``: the unit vector to its goal), from
    this step's own differences between the devices.  Near its goal the
    frame is ill-conditioned: positions a few ulps apart turn it by up to
    2 |dpos| / dist_to_goal, and each heading relative to it moves by that
    turn, each vector projected on it by the turn times the vector's length.
    The slack is 3 times those first-order bounds (sqrt(2) for the
    max-norm, and to spare).  Returns the slack of each leaf and the
    largest turn."""
    cs, ks, obs = cpu[0], card[0].to("cpu"), cpu[1]
    dpos = (ks.pos - cs.pos).abs().amax(-1)                              # [E, A]
    turn = torch.maximum((ks.ref_prll - cs.ref_prll).abs(),
                         (ks.ref_orth - cs.ref_orth).abs()).amax(-1)     # [E, A]
    frame = (3 * dpos / cs.dist_to_goal.clamp(min=1e-6))[..., None]

    def projected(rows):
        """``[E, A, (K,) 7]`` sensed rows: their (x, y) and (vx, vy) pairs are
        in the host's frame."""
        t = 3 * turn.reshape(turn.shape + (1,) * (rows.dim() - 3))
        out = torch.zeros_like(rows)
        out[..., 0:2] = (t * torch.hypot(rows[..., 0], rows[..., 1]))[..., None]
        out[..., 2:4] = (t * torch.hypot(rows[..., 2], rows[..., 3]))[..., None]
        return out

    speed = torch.hypot(cs.vel_ego_frame[..., 0], cs.vel_ego_frame[..., 1])
    slack = {"state.ref_prll": frame, "state.ref_orth": frame,
             "state.heading_ego_frame": 3 * turn,
             "state.vel_ego_frame": (3 * turn * speed)[..., None],
             "state.other_agent_states": projected(cs.other_agent_states),
             "state.sensed_others": projected(cs.sensed_others),
             "obs.heading_ego_frame": (3 * turn)[..., None],
             "obs.other_agents_states": projected(obs["other_agents_states"])}
    return slack, float(turn.max())


def held_with_frame_slack(name, cpu, card, envs):
    """``compare_steps`` at ``phase_card_vs_cpu``'s tolerances with the goal
    frame's slack, on ``envs``; the numbers to print."""
    slack, turn = goal_frame_slack(cpu, card)
    worst, slackened = compare_steps(name, cpu, card, 1e-5, 1e-6, envs, slack)
    return {"envs_compared": int(envs.sum()), "max_abs_err": worst,
            "largest_goal_frame_turn": turn, "entries_within_frame_slack_only": slackened}


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
    states: discrete outputs equal, floats to rtol 1e-5 / atol 1e-6."""
    from gym_collision_avoidance_torch import env_step
    from gym_collision_avoidance_torch.env import autoreset

    cfg, pool, policy_id = main_path_config()
    E = 256
    state = autoreset.state_from_case(cfg, pool[np.arange(E) % len(pool)], policy_id,
                                      device="cpu")
    for _ in range(15):
        state = env_step(state, None, cfg)[0]
    cpu = env_step(state, None, cfg)
    card = env_step(state.to(DEVICE), None, cfg)
    torch.cuda.synchronize()
    worst, _ = compare_steps("card_vs_cpu", cpu, card, 1e-5, 1e-6)
    check(bool(cpu[0].in_collision.any()) and bool(cpu[0].is_at_goal.any()),
          "the compared step should hold collisions and arrivals")
    print(json.dumps({"card_vs_cpu": {"envs": E, "max_abs_err": worst,
                                      "discrete_equal": True}}), flush=True)


def mid_episode_states(cfg, pool, policy_id, params, num_envs, steps):
    """States ``steps`` auto-reset steps into the serving loop, on the card."""
    from gym_collision_avoidance_torch.env import autoreset

    step = autoreset.make_autoreset_step(cfg, pool, policy_id, (int(policy_id[0]),),
                                         params=params, device=DEVICE)
    state = autoreset.state_from_case(cfg, pool[np.arange(num_envs) % len(pool)], policy_id,
                                      device=DEVICE)
    counter = torch.arange(num_envs, dtype=torch.int32, device=DEVICE)
    for _ in range(steps):
        state, counter = step(state, counter)[:2]
    return state


def phase_policy_card_vs_cpu():
    """One env_step of ga3c4 (E = 4096) and of orca4 (E = 16384) on the card
    and on the CPU from the same mid-episode float32 states.

    GA3C: the action indices agree on at least 99.99% of agents, and every
    mismatch sits where the CPU's top two probs differ by less than 1e-5
    (cuBLAS sums in another order than the CPU, and sigmoid, tanh and
    softmax differ by ulps).  ORCA: velocities within rtol 1e-4 /
    atol 1e-5.  The step's other outputs are held as ``phase_card_vs_cpu``
    holds them, on the envs whose agents all agree on their action index or
    LP branch, with the slack of :func:`goal_frame_slack` on the outputs in
    an agent's goal frame."""
    from gym_collision_avoidance_torch import env_step
    from gym_collision_avoidance_torch.core.device import params_to_device
    from gym_collision_avoidance_torch.ops import orca
    from gym_collision_avoidance_torch.policies import ga3c, registry, rvo

    result = {}
    cfg, pool, pid, params = ga3c4_config()
    state = mid_episode_states(cfg, pool, pid, params, E_GA3C4, 15)
    cpu_state, cpu_params = state.to("cpu"), params_to_device(params, "cpu")
    want = ga3c.ga3c_cadrl_probs(cpu_state, cpu_params)
    got = ga3c.ga3c_cadrl_probs(state, params).cpu()
    idx_cpu, idx_card = want.argmax(-1), got.argmax(-1)
    differ = idx_cpu != idx_card
    top2 = torch.topk(want, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1])[differ]
    check(float(differ.double().mean()) <= 1e-4,
          f"GA3C: {int(differ.sum())} of {differ.numel()} action indices differ")
    largest = float(margin.max()) if len(margin) else None
    check(largest is None or largest < 1e-5, f"GA3C: a mismatch with a CPU margin of {largest}")
    agree = ~differ.reshape(E_GA3C4, A_MAIN).any(dim=-1)
    cpu = env_step(cpu_state, None, cfg, cpu_params, (registry.GA3C_CADRL,))
    card = env_step(state, None, cfg, params, (registry.GA3C_CADRL,))
    torch.cuda.synchronize()
    result["ga3c4"] = {
        "envs": E_GA3C4, "agents": differ.numel(), "action_index_mismatches": int(differ.sum()),
        "largest_mismatch_margin": largest,
        "max_prob_diff": float((got - want).abs().max()),
        **held_with_frame_slack("ga3c4", cpu, card, agree)}

    cfg, pool, pid, _ = orca4_config()
    state = mid_episode_states(cfg, pool, pid, None, E_ORCA4, 12)
    cpu_state = state.to("cpu")
    vel, branch = orca.orca_solve(*rvo.orca_inputs(state, cfg, None))
    want_vel, want_branch = orca.orca_solve(*rvo.orca_inputs(cpu_state, cfg, None))
    vel, branch = vel.cpu(), branch.cpu()
    check(torch.allclose(vel, want_vel, rtol=1e-4, atol=1e-5),
          f"ORCA velocities differ by up to {max_abs_err(vel, want_vel)}")
    agree = (branch == want_branch).all(dim=-1)
    cpu = env_step(cpu_state, None, cfg, None, (registry.RVO,))
    card = env_step(state, None, cfg, None, (registry.RVO,))
    torch.cuda.synchronize()
    result["orca4"] = {
        "envs": E_ORCA4, "max_velocity_diff": max_abs_err(vel, want_vel),
        "velocities_bitwise_equal": bitwise_equal(vel, want_vel),
        "lp_branch_differs": int((branch != want_branch).sum()),
        "agents_in_lp3": int((want_branch < A_MAIN - 1).sum()),
        **held_with_frame_slack("orca4", cpu, card, agree), **orca_times(state, cfg)}
    print(json.dumps({"policy_card_vs_cpu": result}), flush=True)


# ---------------------------------------------------------------- laser path

@contextlib.contextmanager
def capture(module, name, calls):
    """Record the arguments of every call of ``module.name``."""
    orig = getattr(module, name)

    def spy(*args):
        calls.append(args)
        return orig(*args)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def bitwise_equal(a, b):
    itype = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(itype),
                                                                     b.view(itype))


def laser_config(fast, dtype="float32", **overrides):
    """``scripts/bench_all.py:bench_ga3c20_laser``'s EnvConfig; ``fast=False``
    drops its wedge, window and beam slots (the full pass, K2)."""
    from gym_collision_avoidance_torch import EnvConfig

    kw = dict(dtype=dtype, max_num_other_agents_observed=19,
              agent_sorting_method="closest_last", use_static_map=True,
              map_x_width=20.0, map_y_width=20.0, laserscan_length=L_LASER)
    if fast:
        kw.update(laserscan_num_candidate_discs=9, laserscan_entry_window=12,
                  laserscan_beam_slots=4)
    kw.update(overrides)
    return EnvConfig(**kw)


def laser_pool():
    """The one-case pool: ``circle_scenario(20, radius=8.0, agent_radius=0.3)``."""
    from gym_collision_avoidance_torch.scenarios import presets

    sc = presets.circle_scenario(A_LASER, radius=8.0, agent_radius=0.3)
    rows = np.concatenate([sc.pos, sc.goal, sc.pref_speed[:, None], sc.radius[:, None]], -1)
    return rows[None]


def static_inputs(cfg, map_name=None, pad=0):
    from gym_collision_avoidance_torch.maps import grid

    static = grid.load_static_map(cfg, None if map_name is None else grid.world_map_path(map_name))
    cells = grid.occupied_cell_list(static, int(static.sum()) + pad)
    return (torch.as_tensor(static, device=DEVICE), torch.as_tensor(cells, device=DEVICE))


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

    cfg = laser_config(False)
    cases = [("f32 full width, empty map", cfg, E_LASER, None, False),
             ("f32, map 002 (84 cells + 16 padding rows)", cfg, 32, "002", False),
             ("f64", laser_config(False, "float64"), 8, None, False),
             ("f32, E*A = 35, invalid and off-map agents", cfg, 7, "002", True),
             ("f64, map 002", laser_config(False, "float64"), 8, "002", False)]
    worst, timed = 0.0, {}
    for i, (name, c, E, map_name, odd) in enumerate(cases):
        _static, cells = static_inputs(c, map_name, pad=16 if map_name else 0)
        state = laser_states(c, E, 10 + i, DEVICE, A=5 if odd else A_LASER, odd=odd)
        args, out, err = held(name, c, state, cells)
        worst = max(worst, err)
        timed.setdefault("empty", (args, out))
    for name in band.CASES:
        for dtype in ("float32", "float64"):
            c, state, cells = band.build_case(name, dtype, DEVICE)
            worst = max(worst, held(f"{dtype[5:]}-bit band case {name}", c, state, cells)[2])
    # full width on map 002, for the per-source screen's share
    _static, cells = static_inputs(cfg, "002", pad=16)
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

    cfg = laser_config(True)
    cases = [("f32 full width, empty map", cfg, E_LASER, None, False),
             ("f32, Cs = 1 (slots overflow)", laser_config(True, laserscan_beam_slots=1),
              32, None, False),
             ("f32, map 002 cells", cfg, 32, "002", False),
             ("f64", laser_config(True, "float64"), 8, None, False),
             ("f32, invalid and off-map agents", cfg, 7, "002", True)]
    worst, timed = 0.0, {}
    for i, (name, c, E, map_name, odd) in enumerate(cases):
        _static, cells = static_inputs(c, map_name, pad=16 if map_name else 0)
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
    _static, cells = static_inputs(cfg, "002", pad=16)
    args, out, _err, _ovf = held("f32 full width, map 002", cfg,
                                 laser_states(cfg, E_LASER, 25, DEVICE), cells)
    timed["map_002"] = (args, out)
    b1 = laser_config(True, laserscan_num_candidate_discs=None)
    _static, cells = static_inputs(b1)
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


def laser_policy():
    """GA3C-CADRL agents with the iros18 weights, as ``bench_ga3c20_laser``
    runs them (19 LSTM steps for 20 agents)."""
    from gym_collision_avoidance_torch.models import ga3c_cadrl
    from gym_collision_avoidance_torch.policies import registry

    return (np.full(A_LASER, registry.GA3C_CADRL, np.int32),
            {"ga3c_cadrl": ga3c_cadrl.load_params(device=DEVICE)})


def phase_laser_serving(fast, kernels):
    """Drive AutoresetServer on the laser path: the counts go to 0 after
    construction, and K1 and the route's laser kernel must launch once per
    step."""
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer

    cfg = laser_config(fast)
    static, cells = static_inputs(cfg)
    pid, params = laser_policy()
    server = AutoresetServer(cfg, laser_pool(), pid, params=params,
                             num_envs=E_LASER, steps_per_dispatch=LASER_STEPS,
                             sensors=("other_agents_states", "laserscan"),
                             states_in_obs=("num_other_agents", "dist_to_goal",
                                            "heading_ego_frame", "pref_speed", "radius",
                                            "other_agents_states", "laserscan"),
                             static_map=static, static_cells=cells, device=DEVICE)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.LAUNCHES = 0
    server.dispatch()                                   # warm-up dispatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LASER_DISPATCHES):
        out = server.dispatch()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: k.LAUNCHES for n, k in kernels.items()}
    steps = (LASER_DISPATCHES + 1) * LASER_STEPS
    laser = "laser_fused" if fast else "raymarch"
    idle = "raymarch" if fast else "laser_fused"
    check(launches["pairwise"] == steps, f"K1 launched {launches['pairwise']} in {steps} steps")
    check(launches[laser] == steps, f"{laser} launched {launches[laser]} in {steps} steps")
    check(launches[idle] == 0, f"{idle} launched {launches[idle]} times")
    for name, leaf in server.states().items():
        if leaf.is_floating_point():
            check(bool(torch.isfinite(leaf).all()), f"non-finite state leaf {name}")
    check(bool(torch.isfinite(out["mean_reward"]).all()), "non-finite reward")
    episodes = server.episodes_completed()
    check(episodes > 0, "no episode completed")
    timed = LASER_DISPATCHES * LASER_STEPS
    line = {"num_envs": E_LASER, "agents": A_LASER, "beams": L_LASER, "steps": steps,
            "timed_steps": timed, "seconds": seconds,
            "env_steps_per_s": timed * E_LASER / seconds, "ms_per_step": 1e3 * seconds / timed,
            "episodes_completed": episodes, "launches": launches}
    if fast:
        line["exactness_overflow"] = server.exactness_overflow()
        line["steps_with_overflow"] = int(out["exactness_overflow"].sum())
    print(json.dumps({"laser_serving_fast" if fast else "laser_serving_full": line}),
          flush=True)
    return launches, server.states()


def phase_fast_vs_full(states):
    """Continue the full pass's trajectory for 64 steps; on every 8th step's
    states the fast route's ranges equal the full pass's bitwise wherever
    its guard is quiet."""
    from gym_collision_avoidance_torch.env import autoreset
    from gym_collision_avoidance_torch.obs import sensors
    from gym_collision_avoidance_torch.policies import registry

    full, fast = laser_config(False), laser_config(True)
    static, cells = static_inputs(full)
    pid, params = laser_policy()
    step = autoreset.make_autoreset_step(full, laser_pool(), pid, (registry.GA3C_CADRL,),
                                         ("other_agents_states", "laserscan"), params=params,
                                         device=DEVICE, static_map=static, static_cells=cells)
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
    the same states: discrete outputs equal, floats to rtol 1e-5 /
    atol 1e-6, laserscan ranges equal on at least 99.99% of the entries
    (float32 sin/cos differ by ulps between the devices)."""
    from gym_collision_avoidance_torch import env_step
    from gym_collision_avoidance_torch.policies import registry

    E = 16
    sensors = ("other_agents_states", "laserscan")
    obs_keys = ("dist_to_goal", "radius", "other_agents_states", "laserscan")
    result = {}
    for fast in (False, True):
        cfg = laser_config(fast)
        static, cells = static_inputs(cfg, "002")
        cpu_args = (static.cpu(), cells.cpu())
        state = laser_states(cfg, E, 31, "cpu")
        for _ in range(3):
            state = env_step(state, None, cfg, None, (registry.NONCOOP,), sensors, obs_keys,
                             *cpu_args)[0]
        cpu = env_step(state, None, cfg, None, (registry.NONCOOP,), sensors, obs_keys,
                       *cpu_args)
        card = env_step(state.to(DEVICE), None, cfg, None, (registry.NONCOOP,), sensors,
                        obs_keys, static, cells)
        torch.cuda.synchronize()
        pairs = [(f"state.{k}", v, getattr(card[0], k)) for k, v in cpu[0].items()]
        pairs += [(f"obs.{k}", v, card[1][k]) for k, v in cpu[1].items()]
        pairs += [("rewards", cpu[2], card[2]), ("game_over", cpu[3], card[3])]
        pairs += [(f"info.{k}", v, card[4][k]) for k, v in cpu[4].items()]
        worst, laser_diff, laser_n = 0.0, 0, 0
        for name, want, got in pairs:
            got = got.cpu()
            check(got.shape == want.shape and got.dtype == want.dtype, f"{name} shape/dtype")
            if name in ("state.laserscan_history", "obs.laserscan"):
                laser_diff += int((got != want).sum())
                laser_n += want.numel()
            elif want.is_floating_point():
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True),
                      f"{name} differs beyond rtol 1e-5 / atol 1e-6")
                worst = max(worst, max_abs_err(got, want))
            else:
                check(torch.equal(got, want), f"{name} differs")
        check(laser_diff <= 1e-4 * laser_n, f"laserscan: {laser_diff} of {laser_n} differ")
        check(bool(cpu[0].in_collision.any()), "the compared step should hold collisions")
        result["fast" if fast else "full"] = {
            "envs": E, "max_abs_err": worst, "laser_entries_differing": laser_diff,
            "laser_entries": laser_n, "wall_or_agent_collisions": int(cpu[0].in_collision.sum()),
            "discrete_equal": True}
    print(json.dumps({"laser_card_vs_cpu": result}), flush=True)


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
    k1_paths = {}
    k1_paths["main"], _ = phase_serving("serving", kernels, *main_path_config(), None, E_MAIN)
    k1_paths["ga3c4"], _ = phase_serving("ga3c4_serving", kernels, *ga3c4_config(), E_GA3C4)
    k1_paths["orca4"], _ = phase_serving("orca4_serving", kernels, *orca4_config(), E_ORCA4)
    phase_card_vs_cpu()
    phase_policy_card_vs_cpu()
    full, states = phase_laser_serving(False, kernels)
    fast, _ = phase_laser_serving(True, kernels)
    phase_fast_vs_full(states)
    phase_laser_card_vs_cpu()

    k1_paths.update(laser_full=full["pairwise"], laser_fast=fast["pairwise"])
    k1["launches"], k1["launches_by_path"] = k1_paths["main"], k1_paths
    k2["launches"] = full["raymarch"]
    k2["launches_by_path"] = {"laser_full": full["raymarch"], "laser_fast": fast["raymarch"]}
    k3["launches"] = fast["laser_fused"]
    k3["launches_by_path"] = {"laser_full": full["laser_fused"],
                              "laser_fast": fast["laser_fused"]}
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
