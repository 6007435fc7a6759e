"""The serving driver: one closed-loop client of the port's
``AutoresetServer``.

Set-up builds the server on the cell's configuration (with the sensors,
observation keys and static map that its ``world`` names) and a pool drawn
from the seed, and warms it up.  The window dispatches S steps of E envs and
reads each dispatch's ``mean_reward`` and ``obs_checksum`` back before the
next, for ``--seconds``; a few dispatches, drawn from the seed, are
snapshotted on either side.  With ``--trace 1`` the profiler then covers a
short stretch.  After the window the same server runs a few more dispatches
with the policy's outputs recorded (where the configuration names the
function that returns them, ``program.policy_output``); the program is
freed, and the plain
reference (``perfbench/reference/``) follows each snapshotted dispatch from
the program's state before it (the start, the initial states, by itself)
and judges the program's states, counters, reads and policy outputs
(``perfbench/check.py``).
"""

from __future__ import annotations

import importlib
import subprocess
import time
import types

import numpy as np
import torch

from perfbench import check, scenarios
from perfbench import trace as trace_mod


def _resolve(spec: str):
    module, attr = spec.split(":")
    return importlib.import_module(module), attr


def _program_params(config: dict, device) -> dict:
    params = {}
    for key, spec in config["program"].get("params", {}).items():
        module, attr = _resolve(spec["loader"])
        params[key] = getattr(module, attr)(**spec["args"], device=device)
    return params


def _world(config: dict, cfg, device) -> dict:
    """``AutoresetServer``'s sensor, observation and map keywords from the
    configuration's ``world``: none where it names none, so that the server
    takes its defaults.  The one static map is ``"empty"``: the env's map
    size with no occupied cell, handed with its (empty) cell list, so that
    the card takes the laser's sparse route."""
    world = config.get("world", {})
    kw = {k: tuple(world[k]) for k in ("sensors", "states_in_obs") if k in world}
    if "static_map" in world:
        if world["static_map"] != "empty":
            raise ValueError(f"no static map {world['static_map']!r}: the benchmark builds "
                             "the empty map only")
        from gym_collision_avoidance_torch.harness.paths import map_inputs

        kw["static_map"], kw["static_cells"] = map_inputs(cfg, device)
    return kw


def _snapshot(server):
    """The server's states as a ``{field: tensor}`` copy and its counters
    (the public, synchronising accessors)."""
    states = server.states()
    fields = {name: leaf.clone() for name, leaf in states.items()}
    return fields, server.counters().clone()


def _read(out, keys):
    return {k: out[k].detach().cpu().numpy().astype(np.float64) for k in keys}


class _Recorder:
    """Records what ``module.attr`` returns while installed."""

    def __init__(self, spec: str):
        self.module, self.attr = _resolve(spec)
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)

        def recorded(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.calls.append(out.detach().clone())
            return out

        setattr(self.module, self.attr, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(config, traffic, limits, seed, seconds, trace, device, t_start, control):
    from gym_collision_avoidance_torch.config import EnvConfig
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = device.type == "cuda"
    E, S = int(traffic["num_envs"]), int(traffic["steps_per_dispatch"])
    A = int(config["num_agents"])
    reads = tuple(traffic["read"])
    pool_seed, sample_seed = np.random.SeedSequence(seed).generate_state(2)
    pc = traffic["pool"]
    pool = scenarios.scenario_pool(pc["cases"], A, seed=int(pool_seed),
                                   side_length=pc["side_length"], speed_bnds=pc["speed_bnds"],
                                   radius_bnds=pc["radius_bnds"])
    policy_id = np.full(A, config["policy_id"], np.int32)

    # ---- set-up: the program, its fresh states, warm-up
    params = _program_params(config, device)
    if control == "bf16_weights":
        # the net's weights rounded to bfloat16 (kept in float32): a control
        # that runs on any device
        for net in params.values():
            for p in net.parameters():
                p.data = p.data.to(torch.bfloat16).to(p.dtype)
    cfg = EnvConfig(**config["env"])
    server = AutoresetServer(cfg, pool, policy_id, num_envs=E, steps_per_dispatch=S,
                             params=params, device=device, **_world(config, cfg, device))
    start = _snapshot(server)
    for _ in range(int(traffic["warmup_dispatches"])):
        _read(server.dispatch(), reads)
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif control not in ("", "bf16_weights"):
        raise ValueError(f"unknown control {control!r}")
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window
    ck = traffic["check"]
    rng = np.random.default_rng(int(sample_seed))
    sampled = set(rng.choice(int(ck["window_first"]), int(ck["window_samples"]),
                             replace=False).tolist())
    samples, dispatch_s, enqueue_s, failed = [], [], [], 0
    w0 = time.perf_counter()
    while True:
        d = len(dispatch_s)
        before = _snapshot(server) if d in sampled else None
        t0 = time.perf_counter()
        out = server.dispatch()
        t1 = time.perf_counter()
        got = _read(out, reads)
        t2 = time.perf_counter()
        dispatch_s.append(t2 - t0)
        enqueue_s.append(t1 - t0)
        failed += not all(np.isfinite(v).all() for v in got.values())
        if before is not None:
            samples.append({"before": before, "read": got, "after": _snapshot(server)})
        if t2 - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # ---- the traced stretch
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            for _ in range(int(traffic["trace_dispatches"])):
                with record_function("bench.dispatch"):
                    out = server.dispatch()
                with record_function("bench.read"):
                    _read(out, reads)
        tr = trace_mod.reduce(prof, S)

    # ---- dispatches after the window, the policy's outputs recorded
    output = config["program"].get("policy_output")
    for _ in range(int(ck["after_dispatches"])):
        before = _snapshot(server)
        if output:
            with _Recorder(output) as rec:
                got = _read(server.dispatch(), reads)
            calls = rec.calls
        else:
            got, calls = _read(server.dispatch(), reads), None
        samples.append({"before": before, "read": got, "after": _snapshot(server),
                        "policy": calls})
    del server
    if on_card:
        torch.cuda.empty_cache()

    # ---- the reference judges
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings, compared = check.judge_serving(config, pool, start, samples, S, reads, device)
    correct = all(readings[k] <= limits[k] for k in limits) and failed == 0
    steps = len(dispatch_s) * S
    result = {
        "correct": bool(correct), "attempted": len(dispatch_s), "failed": failed,
        "e2e": {"env_steps_per_s": E * steps / window_s,
                "dispatch_p95_ms": float(np.percentile(dispatch_s, 95)) * 1e3,
                "setup_s": setup_s},
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak),
                   "power_limit": _power_limit() if on_card else "none"},
        "policy_steps_compared": compared,
        "check": {k: {"value": readings[k], "limit": limits[k]} for k in limits},
    }
    if trace:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
        result["run"] = types.SimpleNamespace(
            config=config, traffic=traffic, num_envs=E, steps_per_dispatch=S, num_agents=A,
            dispatch_s=dispatch_s, enqueue_s=enqueue_s, window_s=window_s, steps=steps,
            trace=tr, device_kind=result["device"]["kind"])
    return result
