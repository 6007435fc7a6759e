#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc`` under ``/usr/local/cuda`` or on ``PATH``)::

    python3 chip_smoke.py

It builds every hand-written kernel of the port from ``csrc/``, holds each
against its plain PyTorch version on the card, drives the main path (the
4-agent NonCoop auto-reset serving loop that ``bench.py`` times, at
E = 16384 envs) through ``AutoresetServer``, and compares one env step on the
card with the same step on the CPU.  Every phase raises on failure, so the
exit code is 0 only if all passed.  The last three lines of its output are
the kernels' JSON summary, the card's ``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
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


def phase_kernels(pairwise, build):
    """Build K1 and hold it bitwise against the plain version; time both at
    the main path's shape, on the device (CUDA graph replay) and as eager
    calls."""
    t0 = time.perf_counter()
    build.build(["pairwise"])
    print(f"build: pairwise.cu in {time.perf_counter() - t0:.1f} s", flush=True)

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
               "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms}
    print(json.dumps(summary), flush=True)
    return {"name": "pairwise_collisions", "route": "cuda",
            "source": "gym_collision_avoidance_torch/csrc/pairwise.cu",
            "replaces": "gym_collision_avoidance_tpu/ops/pairwise.py:77",
            "launches": None, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def main_path_config():
    from gym_collision_avoidance_torch import EnvConfig
    from gym_collision_avoidance_torch.policies import registry
    from gym_collision_avoidance_torch.scenarios import random_cases

    # the loop bench.py:_bench_serving times
    cfg = EnvConfig(dtype="float32", done_mode="evaluate")
    pool = random_cases.scenario_pool(64, A_MAIN, seed=0, side_length=4.0)
    policy_id = np.full(A_MAIN, registry.NONCOOP, np.int32)
    return cfg, pool, policy_id


def phase_serving(pairwise):
    """Drive AutoresetServer at E = 16384; K1 must launch once per step."""
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer

    cfg, pool, policy_id = main_path_config()
    pairwise.LAUNCHES = 0
    server = AutoresetServer(cfg, pool, policy_id, num_envs=E_MAIN,
                             steps_per_dispatch=STEPS_PER_DISPATCH, device=DEVICE)
    server.dispatch()                                   # warm-up dispatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCHES):
        out = server.dispatch()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = pairwise.LAUNCHES
    steps = (DISPATCHES + 1) * STEPS_PER_DISPATCH
    check(launches == steps, f"K1 launched {launches} times in {steps} steps")

    for name, leaf in server.states().items():
        if leaf.is_floating_point():
            check(bool(torch.isfinite(leaf).all()), f"non-finite state leaf {name}")
    check(bool(torch.isfinite(out["mean_reward"]).all()), "non-finite reward")
    episodes = server.episodes_completed()
    check(episodes > 0, "no episode completed")
    rate = DISPATCHES * STEPS_PER_DISPATCH * E_MAIN / seconds
    print(json.dumps({"serving": {
        "num_envs": E_MAIN, "agents": A_MAIN, "steps": steps,
        "timed_steps": DISPATCHES * STEPS_PER_DISPATCH, "seconds": seconds,
        "env_steps_per_s": rate, "ms_per_step": 1e3 * seconds / (DISPATCHES * STEPS_PER_DISPATCH),
        "episodes_completed": episodes, "k1_launches": launches}}), flush=True)
    return launches


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

    worst = 0.0
    pairs = [(f"state.{k}", v, getattr(card[0], k)) for k, v in cpu[0].items()]
    pairs += [(f"obs.{k}", v, card[1][k]) for k, v in cpu[1].items()]
    pairs += [("rewards", cpu[2], card[2]), ("game_over", cpu[3], card[3])]
    pairs += [(f"info.{k}", v, card[4][k]) for k, v in cpu[4].items()]
    for name, want, got in pairs:
        got = got.cpu()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name} shape/dtype")
        if want.is_floating_point():
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True),
                  f"{name} differs beyond rtol 1e-5 / atol 1e-6")
            worst = max(worst, max_abs_err(got, want))
        else:
            check(torch.equal(got, want), f"{name} differs")
    check(bool(cpu[0].in_collision.any()) and bool(cpu[0].is_at_goal.any()),
          "the compared step should hold collisions and arrivals")
    print(json.dumps({"card_vs_cpu": {"envs": E, "max_abs_err": worst,
                                      "discrete_equal": True}}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    from gym_collision_avoidance_torch.ops import build, pairwise

    smi = nvidia_smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)

    k1 = phase_kernels(pairwise, build)
    k1["launches"] = phase_serving(pairwise)
    phase_card_vs_cpu()

    print(json.dumps({"kernels": [k1]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
