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

``--config train_ga3c4``, ``train_drl2`` or ``train_mlp2`` (the training
paths of ``harness/paths.py``) traces one PPO iteration after a warm-up one
instead and reports the same numbers for its rollout, GAE and update apart
(each a ``torch.profiler`` range of ``PPOTrainer.train_step``, the device
synchronised at its end), with K1's and K2's launches.

``--config suite_cadrl4``, ``suite_rvo4`` or ``suite_ga3c4`` (the evaluation
campaign's 4-agent cells, ``harness/paths.py:SUITE_PATHS``) traces the first
chunk of ``--steps`` lockstep steps (default 128) of
``harness/experiments.py:run_batched_episodes`` over the 500 frozen cases,
after the same chunk run once untraced, and reports the same per-step numbers
(the chunk's state set-up and its one copy to the host included).
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


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _kernel_shares(kernels, per):
    """Device ms (divided by ``per``) of the hand-written kernels, the
    products and the convolutions among ``kernels`` (profiler events)."""
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())

    def share(*kernel):
        return sum(t for name, (_, t) in by_name.items()
                   if any(k in name.lower() for k in kernel)) / 1e3 / per

    def count(kernel):
        return sum(n for name, (n, _) in by_name.items() if kernel in name.lower())

    return by_name, {
        "k1_device_ms": share("pairwise_kernel"), "k2_device_ms": share("raymarch_kernel"),
        "k3_device_ms": share("laser_fused_kernel"),
        "k1_launches": count("pairwise_kernel") / per, "k2_launches": count("raymarch_kernel") / per,
        "gemm_device_ms": share("gemm", "xmma", "gemv"),
        "conv_device_ms": share("conv", "fprop", "dgrad", "wgrad", "cudnn"),
    }


def trace_iteration(trainer, carry, gen, trace=None):
    """Trace one PPO iteration of ``trainer`` from ``carry`` with noise
    from ``gen``: wall and device-busy ms, idle share, kernels and the
    kernel, GEMM and convolution device ms, for the iteration and for each
    phase.  Returns the report and the next carry."""
    from torch.profiler import ProfilerActivity, profile

    cuda = trainer.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        *carry, metrics = trainer.train_step(*carry, rng=gen, timings={})
        sync()
        wall = time.perf_counter() - t0
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
    events = prof.events()
    # device events, less the GPU copies of the phases' ranges (annotations)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ppo_")]
    ranges = {e.name[len("ppo_"):]: e.time_range for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("ppo_")}
    phases = {}
    for phase, rng in sorted(ranges.items(), key=lambda kv: kv[1].start):
        inside = [k for k in kernels if rng.start <= k.time_range.start < rng.end]
        busy_us = sum(k.time_range.elapsed_us() for k in inside)
        _, shares = _kernel_shares(inside, 1)
        phases[phase] = {"wall_ms": rng.elapsed_us() / 1e3,
                         "device_busy_ms": busy_us / 1e3 if inside else "not measured",
                         "device_idle_share": (1 - busy_us / rng.elapsed_us()) if inside
                         else "not measured",
                         "kernels": len(inside), **shares}
    by_name, shares = _kernel_shares(kernels, 1)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    ppo = trainer.ppo
    report = {"device": nvidia_smi() if cuda else "cpu", "num_envs": ppo.num_envs,
              "horizon": ppo.horizon, "env_steps": ppo.num_envs * ppo.horizon,
              "wall_ms_per_iteration": 1e3 * wall,
              "device_busy_ms_per_iteration": busy_us / 1e3 if kernels else "not measured",
              "device_idle_share": (1 - busy_us / 1e6 / wall) if kernels else "not measured",
              "kernels_per_iteration": len(kernels), **shares, "phases": phases,
              "episodes_finished": float(metrics["episodes_finished"]),
              "top_kernels": [{"name": n[:80], "calls": c, "device_ms": t / 1e3}
                              for n, (c, t) in top]}
    return report, carry


def profile_training(name: str, trace=None, num_envs=None) -> dict:
    """:func:`trace_iteration` of the training path ``name`` (at
    ``num_envs`` envs if given) after one warm-up iteration."""
    from gym_collision_avoidance_torch.harness import paths

    path = paths.training_path(name)
    if num_envs:
        path = path.resized(num_envs, path.ppo.horizon)
    trainer = path.trainer("cuda")
    carry = path.init(trainer)
    gen = torch.Generator("cuda").manual_seed(7)
    *carry, _ = trainer.train_step(*carry, rng=gen)
    report, _ = trace_iteration(trainer, carry, gen, trace)
    return {"config": name, **report}


def profile_suite(name: str, steps: int, trace=None) -> dict:
    """One traced chunk of ``steps`` lockstep steps of the suite cell
    ``name`` after an untraced one: wall and device ms per step, idle share,
    kernels per step and the K1 and GEMM shares."""
    from torch.profiler import ProfilerActivity, profile

    from gym_collision_avoidance_torch.harness import experiments, paths

    policy = paths.SUITE_PATHS[name]
    scenarios, cfg, params = experiments.suite_cell(paths.SUITE_AGENTS, policy,
                                                    paths.SUITE_CASES, device="cuda")

    def chunk():
        return experiments.run_batched_episodes(scenarios, cfg, params, chunk_steps=steps,
                                                max_steps=steps, device="cuda")

    chunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name, shares = _kernel_shares(kernels, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device": nvidia_smi(), "config": name, "policy": policy,
            "num_envs": len(scenarios), "agents": paths.SUITE_AGENTS, "steps": steps,
            "wall_ms_per_step": 1e3 * wall / steps,
            "device_busy_ms_per_step": (busy_us / 1e3 / steps) if kernels else "not measured",
            "device_idle_share": (1 - busy_us / 1e6 / wall) if kernels else "not measured",
            "kernels_per_step": len(kernels) / steps,
            **{f"{k[:-3]}_ms_per_step" if k.endswith("_ms") else f"{k}_per_step": v
               for k, v in shares.items()},
            "top_kernels": [{"name": n[:80], "calls": c, "device_ms": t / 1e3}
                            for n, (c, t) in top]}


def main():
    from gym_collision_avoidance_torch.harness import paths

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=paths.PATHS + paths.TRAIN_PATHS + tuple(paths.SUITE_PATHS),
                    default="main")
    ap.add_argument("--num-envs", type=int, default=None, help="default: the path's own")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps traced (default 32; 128, one chunk, for the suite cells)")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.config in paths.SUITE_PATHS:
        print(json.dumps({"profile_suite": profile_suite(args.config, args.steps or 128,
                                                         args.trace)}))
        return 0
    args.steps = args.steps or 32
    if args.config in paths.TRAIN_PATHS:
        print(json.dumps({"profile_training": profile_training(args.config, args.trace,
                                                               args.num_envs)}))
        return 0

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
    steps = args.steps
    by_name, shares = _kernel_shares(kernels, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    print(json.dumps({"profile_serving": {
        "device": nvidia_smi(), "config": args.config, "num_envs": args.num_envs,
        "steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": (busy_us / 1e3 / steps) if kernels else "not measured",
        "device_idle_share": (1 - busy_us / 1e6 / wall) if kernels else "not measured",
        "kernels_per_step": len(kernels) / steps,
        **{f"{k[:-3]}_ms_per_step" if k.endswith("_ms") else f"{k}_per_step": v
           for k, v in shares.items()},
        "top_kernels": [{"name": name[:80], "calls": n, "device_ms": t / 1e3}
                        for name, (n, t) in top],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
