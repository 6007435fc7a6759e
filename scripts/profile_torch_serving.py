#!/usr/bin/env python3
"""Where the time of the PyTorch port's serving loop goes, on one CUDA card.

Builds an ``AutoresetServer`` for one of the port's paths, warms it up,
then traces one dispatch of ``--steps`` steps with ``torch.profiler`` and
prints one JSON line: wall time per step, device busy time per step (the sum
of kernel times, no overlap on one stream), the device's idle share, kernel
launches per step, the hand-written kernels' shares, and the ten kernels
that take the most device time.  The card's ``nvidia-smi`` name and power
limit go beside the numbers.

``--config main`` is the main path (4 NonCoop agents, 64-case pool, float32,
evaluate mode, default 16384 envs).  ``ga3c4`` and ``orca4`` are
``scripts/bench_all.py``'s ``bench_ga3c4_serving`` (4 GA3C-CADRL agents,
iros18 weights, 19 slots sorted closest last, default 4096 envs) and
``bench_orca4`` (4 RVO agents, default 16384 envs) on the same pool.
``laser_full`` and ``laser_fast`` are its ``ga3c20_laser`` configuration (20
GA3C-CADRL agents on the 8 m circle, 512 beams, the empty 20 x 20 m map,
default 256 envs), without and with its fast laserscan route (kernel K2 or
K3).  ``gemm_device_ms_per_step`` sums the matrix-product kernels (cuBLAS
names: gemm, xmma, gemv).

    python3 scripts/profile_torch_serving.py [--config main] [--num-envs N]
        [--steps 32] [--trace results/serving_trace.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("main", "ga3c4", "orca4", "laser_full", "laser_fast"),
                    default="main")
    ap.add_argument("--num-envs", type=int, default=None,
                    help="default 16384 for main and orca4, 4096 for ga3c4, 256 for the "
                         "laser configs")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from gym_collision_avoidance_torch import EnvConfig
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer
    from gym_collision_avoidance_torch.maps import grid
    from gym_collision_avoidance_torch.models import ga3c_cadrl
    from gym_collision_avoidance_torch.policies import registry
    from gym_collision_avoidance_torch.scenarios import presets, random_cases

    if args.config in ("main", "ga3c4", "orca4"):
        args.num_envs = args.num_envs or (4096 if args.config == "ga3c4" else 16384)
        kw = dict(max_num_other_agents_observed=19,
                  agent_sorting_method="closest_last") if args.config == "ga3c4" else {}
        cfg = EnvConfig(dtype="float32", done_mode="evaluate", **kw)
        pool = random_cases.scenario_pool(64, 4, seed=0, side_length=4.0)
        policy = {"main": registry.NONCOOP, "ga3c4": registry.GA3C_CADRL,
                  "orca4": registry.RVO}[args.config]
        params = ({"ga3c_cadrl": ga3c_cadrl.load_params()} if args.config == "ga3c4"
                  else None)
        server = AutoresetServer(cfg, pool, np.full(4, policy, np.int32), params=params,
                                 num_envs=args.num_envs, steps_per_dispatch=args.steps)
    else:
        args.num_envs = args.num_envs or 256
        fast = dict(laserscan_num_candidate_discs=9, laserscan_entry_window=12,
                    laserscan_beam_slots=4) if args.config == "laser_fast" else {}
        cfg = EnvConfig(dtype="float32", max_num_other_agents_observed=19,
                        agent_sorting_method="closest_last", use_static_map=True,
                        map_x_width=20.0, map_y_width=20.0, **fast)
        sc = presets.circle_scenario(20, radius=8.0, agent_radius=0.3)
        pool = np.concatenate([sc.pos, sc.goal, sc.pref_speed[:, None],
                               sc.radius[:, None]], -1)[None]
        static = grid.load_static_map(cfg, None)
        server = AutoresetServer(cfg, pool, np.full(20, registry.GA3C_CADRL, np.int32),
                                 params={"ga3c_cadrl": ga3c_cadrl.load_params()},
                                 num_envs=args.num_envs, steps_per_dispatch=args.steps,
                                 sensors=("other_agents_states", "laserscan"),
                                 static_map=static, static_cells=grid.occupied_cell_list(static))
    server.dispatch()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.dispatch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    def share(*kernel):
        return sum(t for name, (_, t) in by_name.items()
                   if any(k in name.lower() for k in kernel)) / 1e3 / args.steps
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    steps = args.steps
    print(json.dumps({"profile_serving": {
        "device": smi, "config": args.config, "num_envs": args.num_envs, "steps": steps,
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": (busy_us / 1e3 / steps) if kernels else "not measured",
        "device_idle_share": (1 - busy_us / 1e6 / wall) if kernels else "not measured",
        "kernels_per_step": len(kernels) / steps,
        "k1_device_ms_per_step": share("pairwise_kernel"),
        "k2_device_ms_per_step": share("raymarch_kernel"),
        "k3_device_ms_per_step": share("laser_fused_kernel"),
        "gemm_device_ms_per_step": share("gemm", "xmma", "gemv"),
        "top_kernels": [{"name": name[:80], "calls": n, "device_ms": t / 1e3}
                        for name, (n, t) in top],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
