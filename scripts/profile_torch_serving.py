#!/usr/bin/env python3
"""Where the time of the PyTorch port's serving loop goes, on one CUDA card.

Builds an ``AutoresetServer`` for one of the port's paths, warms it up,
then traces one dispatch of ``--steps`` steps with ``torch.profiler`` and
prints one JSON line: wall time per step, device busy time per step (the sum
of kernel times, no overlap on one stream), the device's idle share, kernel
launches per step, the hand-written kernels' shares, and the ten kernels
that take the most device time.  The card's ``nvidia-smi`` name and power
limit go beside the numbers.

``--config`` names one of the paths of
``gym_collision_avoidance_torch/harness/paths.py`` (main, ga3c4, orca4,
cadrl4, drl2, laser_full, laser_fast), which says what each runs and its
default env count.  ``gemm_device_ms_per_step`` sums the
matrix-product kernels (cuBLAS and cuDNN names: gemm, xmma, gemv);
``conv_device_ms_per_step`` the convolution kernels (names with conv,
fprop or cudnn), which may share a name with the first.

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

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from gym_collision_avoidance_torch.harness import paths

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=paths.PATHS, default="main")
    ap.add_argument("--num-envs", type=int, default=None, help="default: the path's own")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    path = paths.serving_path(args.config)
    args.num_envs = args.num_envs or path.num_envs
    server = path.server(num_envs=args.num_envs, steps_per_dispatch=args.steps)
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
        "conv_device_ms_per_step": share("conv", "fprop", "cudnn"),
        "top_kernels": [{"name": name[:80], "calls": n, "device_ms": t / 1e3}
                        for name, (n, t) in top],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
