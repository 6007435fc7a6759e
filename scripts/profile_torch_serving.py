#!/usr/bin/env python3
"""Where the time of the PyTorch port's serving loop goes, on one CUDA card.

Builds an ``AutoresetServer`` for one of the port's paths, warms it up,
times 5 dispatches of ``--steps`` steps on the host clock (to a
synchronise), then traces one more with ``torch.profiler`` and prints one
JSON line: the untraced and the traced wall time per step, device busy time
per step (the device operations' intervals merged), the device's idle share
(1 - busy over the untraced wall), kernel launches per step, the hand-written
kernels' shares, the ten kernels that take the most device time, the share of
the reset pick's gathered pool rows that an episode's reset keeps
(``reset_useful_pct``: episodes finished over E x steps, untraced), and one row
per span of the port's step (``gca.*``, :mod:`utils.profiling`): its own
host ms a step (its duration less its child spans'), and the device ms and
kernels a step of the operations whose launch call ran while it was the
innermost open span (the call found by the profiler's correlation id).  The
card's ``nvidia-smi`` name and power limit go beside the numbers.

``--config`` names one of the paths of
``gym_collision_avoidance_torch/harness/paths.py`` (main, ga3c4, orca4,
cadrl4, drl2, laser_full, laser_fast, ga3c40, sarl6), which says what each runs and
its default env count.  ``gemm_device_ms_per_step`` sums the
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
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.trace import Trace  # noqa: E402  (the benchmark's busy time)

# device operations that are not kernels
NOT_KERNELS = ("Memcpy", "Memset")
# untraced dispatches timed before the traced one
UNTRACED_DISPATCHES = 5
# the host side of a launch: a CUDA runtime or driver call
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def device_ops(events):
    """The device's work among profiler events: kernels, copies and fills,
    less the device-side copies of ``record_function`` ranges (the port's
    ``gca.*`` spans, the trainer's ``ppo_*`` phases), left out both by the
    profiler's flag and by name."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("gca.", "ppo_"))]


def span_rows(events, per):
    """One row per ``gca.*`` span name among the raw profiler events
    ``events`` (``prof.profiler.kineto_results.events()``), divided by
    ``per``: ``host_ms``, the host time of its ranges less the part their
    child spans cover; ``device_ms`` and ``kernels``, those of the device
    operations whose launch call ran while the span was the innermost one
    open.  A launch call is the CUDA runtime or driver call (``cuda*``,
    ``cu*``) that shares the operation's correlation id; operations with
    none inside a span make the row ``(none)``."""
    def on_host(ev):
        return "CUDA" not in str(ev.device_type())

    spans = sorted(((ev.name(), ev.start_ns(), ev.end_ns()) for ev in events
                    if on_host(ev) and ev.name().startswith("gca.")),
                   key=lambda sp: (sp[1], -sp[2]))
    launch = {ev.correlation_id(): ev.start_ns() for ev in events
              if on_host(ev) and RUNTIME_CALL.match(ev.name())}

    def innermost(t):
        inside = [sp for sp in spans if sp[1] <= t < sp[2]]
        return max(inside, key=lambda sp: sp[1])[0] if inside else "(none)"

    rows = {}

    def row(name):
        return rows.setdefault(name, {"host_ms": 0.0, "device_ms": 0.0, "kernels": 0})

    for i, (name, start, end) in enumerate(spans):
        children, last = 0, start
        for _, c_start, c_end in spans[i + 1:]:
            if c_start >= end:
                break
            if c_start >= last:     # a direct child: not inside an earlier one
                children += c_end - c_start
                last = c_end
        row(name)["host_ms"] += (end - start - children) / 1e6 / per
    for ev in events:
        if (not on_host(ev) and not ev.is_user_annotation()
                and not ev.name().startswith(("gca.", "ppo_"))):
            r = row(innermost(launch.get(ev.correlation_id(), -1)))
            r["device_ms"] += (ev.end_ns() - ev.start_ns()) / 1e6 / per
            r["kernels"] += 1 / per
    return rows


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
    kernels = device_ops(events)
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
    kernels = device_ops(prof.events())
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


def profile_serving(name: str, num_envs=None, steps: int = 32, trace=None,
                    device="cuda") -> dict:
    """One traced dispatch of ``steps`` steps of the serving path ``name``
    (at ``num_envs`` envs if given) after one warm-up dispatch and
    :data:`UNTRACED_DISPATCHES` timed ones; on the CPU the device columns
    read "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    from gym_collision_avoidance_torch.harness import paths

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    path = paths.serving_path(name, device)
    num_envs = num_envs or path.num_envs
    server = path.server(num_envs=num_envs, steps_per_dispatch=steps, device=device)
    server.dispatch()
    episodes = server.episodes_completed()          # synchronises
    t0 = time.perf_counter()
    for _ in range(UNTRACED_DISPATCHES):
        server.dispatch()
    sync()
    untraced = (time.perf_counter() - t0) / UNTRACED_DISPATCHES
    # every env's reset pick gathers a pool row each step; a finished episode
    # keeps one (both counts over all envs, every rank's under a mesh)
    episodes = server.episodes_completed() - episodes
    gathered = server.num_envs * steps * UNTRACED_DISPATCHES

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        server.dispatch()
        sync()
        wall = time.perf_counter() - t0
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)

    events = prof.events()
    ops = device_ops(events)
    kernels = [e for e in ops if not e.name.startswith(NOT_KERNELS)]
    busy = Trace(ops=[(e.name, e.time_range.start, e.time_range.end) for e in ops],
                 spans=[], window_s=0.0, steps=steps).busy_s() / 1e3
    by_name, shares = _kernel_shares(kernels, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "device": nvidia_smi() if cuda else "cpu", "config": name, "num_envs": num_envs,
        "steps": steps, "untraced_wall_ms_per_step": 1e3 * untraced / steps,
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy / steps if ops else "not measured",
        "device_idle_share": (1 - busy / 1e3 / untraced) if ops else "not measured",
        "kernels_per_step": len(kernels) / steps,
        **{f"{k[:-3]}_ms_per_step" if k.endswith("_ms") else f"{k}_per_step": v
           for k, v in shares.items()},
        "reset_useful_pct": 100 * episodes / gathered,
        "spans_per_step": span_rows(prof.profiler.kineto_results.events(), steps),
        "top_kernels": [{"name": n[:80], "calls": c, "device_ms": t / 1e3}
                        for n, (c, t) in top],
    }


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

    print(json.dumps({"profile_serving": profile_serving(args.config, args.num_envs,
                                                         args.steps, args.trace)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
