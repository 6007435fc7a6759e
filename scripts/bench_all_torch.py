"""Multi-config throughput benchmark of the PyTorch port (the counterpart of
``scripts/bench_all.py``), on one CUDA card, or the CPU with ``--device cpu``.

Reports env-steps/s for the rows of ``scripts/bench_all.py``, each with the
JAX row's env arithmetic, configuration, policies, sensors and pipeline
depth:

  - noncoop4 / autoreset4: 4-agent NonCoop (fixed scenario / serving loop)
  - rvo4 / orca4: 4-agent ORCA-RVO (fixed scenario / serving loop)
  - cadrl4: 4-agent SA-CADRL (47-action lookahead + value net), E // 4
  - ga3c4 / ga3c4_bf16 / ga3c4_serving: 4-agent GA3C-CADRL (LSTM), E // 4,
    float32 or bfloat16 weights / the serving loop
  - ga3c20_laser: 20-agent GA3C + sparse laserscan (fast route), E // 16
  - ga3c40: the LargeNumAgents regime, 40 agents, 19 observed, E // 32
  - ppo_train: PPO training (rollout + GAE + 4 update epochs), mlp, 2 agents

The fixed-scenario rows (``harness/paths.py:fixed_row``) broadcast one
circle scenario to every env and step it with ``batched_env_step`` and no
reset, so envs whose episodes ended go on stepping frozen states, as the
JAX rows do.  The serving rows run ``AutoresetServer``; ppo_train runs the
port's PPO trainer.  A timed window runs ``pipeline`` dispatches of
``--steps`` steps (ppo_train: of one training iteration) with no host read
between them and ends in ``torch.cuda.synchronize()``; the host clock goes
around it.  Each row reports the median over ``reps`` windows with the
spread, its ``num_steps``, ``pipeline`` and ``reps``, the shortest window's
seconds, and ``reduced``: each cut against the JAX row (a row function's
``reps`` and ``pipeline`` override the row's own, for short runs).

Usage: python3 scripts/bench_all_torch.py [--envs 4096] [--steps 128]
           [--configs name ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

JAX_REPS = 3   # bench_config's and _autoreset_serving's timed windows


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_windows(device, dispatch, work, reps, pipeline):
    """``reps`` windows of ``pipeline`` calls of ``dispatch`` with no host
    read between them, each ending in a synchronise; returns the sorted
    rates (``work`` env-steps a call over the window's host seconds), the
    shortest window's seconds and what the calls returned."""
    rates, seconds, outs = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _p in range(pipeline):
            outs.append(dispatch())
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        rates.append(pipeline * work / seconds[-1])
    return sorted(rates), min(seconds), outs


def _row(name, num_envs, rates, num_steps, pipeline, reps, window, reduced, **keys):
    """A row under the JAX row's keys (median and spread of ``rates``), with
    the run's shape and cuts."""
    return {"config": name, "num_envs": num_envs, **keys,
            "env_steps_per_sec": rates[len(rates) // 2],
            "spread_min": rates[0], "spread_max": rates[-1],
            "num_steps": num_steps, "pipeline": pipeline, "reps": reps,
            "window_seconds_min": window, "reduced": reduced}


def _depth(reps, pipeline, jax_reps, jax_pipeline):
    """``(reps, pipeline, cuts)``: the overrides, or the JAX row's."""
    reps = jax_reps if reps is None else reps
    pipeline = jax_pipeline if pipeline is None else pipeline
    cuts = [f"{k} {j} -> {v}" for k, j, v in (("reps", jax_reps, reps),
                                               ("pipeline", jax_pipeline, pipeline)) if v != j]
    return reps, pipeline, cuts


def bench_config(name, num_envs, num_steps, device=None, reps=None, pipeline=None):
    """A fixed-scenario row (``bench_all.py:bench_config``) at the bench's
    ``num_envs`` (the row divides it)."""
    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.harness import paths

    device = resolve_device(device)
    row = paths.fixed_row(name, device)
    reps, pipeline, reduced = _depth(reps, pipeline, JAX_REPS, row.pipeline)
    E = num_envs // row.envs_divisor
    states = row.states(E, device)
    no_overflow = torch.zeros((), dtype=torch.bool, device=device)

    def run():
        nonlocal states
        metrics = []
        for _ in range(num_steps):
            states, _obs, rew, go, info = row.step(states)
            # the laserscan fast route's exactness guard: a trip means the
            # trajectory left the regime where the fast route equals the
            # full pass, and the row must fail rather than time it
            ovf = info.get("laserscan_exactness_overflow", no_overflow)
            metrics.append((rew.mean(), go.to(torch.float32).mean(), ovf.any()))
        return metrics

    def check(runs):
        if bool(torch.stack([m[2] for ms in runs for m in ms]).any()):
            raise RuntimeError(
                f"{name}: laserscan exactness overflow: the configured "
                "laserscan_entry_window/num_candidate_discs is too small for this "
                "trajectory; the bench would measure a divergent simulation")

    check([run()])
    _sync(device)
    rates, window, runs = timed_windows(device, run, E * num_steps, reps, pipeline)
    check(runs)
    agents = row.scenario.num_agents
    return _row(name, E, rates, num_steps, pipeline, reps, window, reduced,
                agent_steps_per_sec=rates[len(rates) // 2] * agents)


def bench_noncoop4(E, S, **kw):
    return bench_config("noncoop4", E, S, **kw)


def bench_rvo4(E, S, **kw):
    return bench_config("rvo4", E, S, **kw)


def bench_cadrl4(E, S, **kw):
    return bench_config("cadrl4", E, S, **kw)


def bench_ga3c4(E, S, **kw):
    return bench_config("ga3c4", E, S, **kw)


def bench_ga3c4_bf16(E, S, **kw):
    return bench_config("ga3c4_bf16", E, S, **kw)


def bench_ga3c20_laser(E, S, **kw):
    return bench_config("ga3c20_laser", E, S, **kw)


def bench_ga3c40(E, S, **kw):
    # official settings (bench_all.py:398-401): --envs 16384 --steps 256
    return bench_config("ga3c40", E, S, **kw)


def autoreset_serving(name, path_name, E, S, device=None, reps=None, pipeline=None,
                      jax_pipeline=4):
    """A serving row (``bench_all.py:_autoreset_serving``): ``path_name``'s
    ``AutoresetServer`` of E envs from the 64-case pool, its one policy
    active, ``pipeline`` dispatches of S steps a window.  ``nan_free``: every
    float leaf of the final states is finite; ``episodes_completed``: the
    episodes finished since construction."""
    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.harness import paths

    device = resolve_device(device)
    reps, pipeline, reduced = _depth(reps, pipeline, JAX_REPS, jax_pipeline)
    path = paths.serving_path(path_name, device)
    server = path.server(num_envs=E, steps_per_dispatch=S, active_policies=path.active,
                         device=device)
    server.dispatch()
    _sync(device)
    rates, window, _ = timed_windows(device, server.dispatch, E * S, reps, pipeline)
    nan_free = all(bool(torch.isfinite(leaf).all())
                   for _, leaf in server.states().items() if leaf.is_floating_point())
    return _row(name, E, rates, S, pipeline, reps, window, reduced, nan_free=nan_free,
                episodes_completed=server.episodes_completed())


def bench_autoreset4(E, S, **kw):
    return autoreset_serving("autoreset4", "main", E, S, **kw)


def bench_ga3c4_serving(E, S, **kw):
    return autoreset_serving("ga3c4_serving", "ga3c4", E // 4, S, jax_pipeline=8, **kw)


def bench_orca4(E, S, **kw):
    # ORCA reads its LP3 flag on the host once a step (ops/orca.py)
    return autoreset_serving("orca4", "orca4", E, S, **kw)


def bench_ppo_train(E, S, num_agents=2, arch="mlp", device=None, reps=None, pipeline=None):
    """PPO training throughput (``bench_all.py:bench_ppo_train``): the
    trainer at ``min(E, 2048)`` envs, horizon 64, ``S // 64`` windows of 16
    chained iterations; env-steps count rollout steps only."""
    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.train import PPOConfig, make_ppo

    device = resolve_device(device)
    reps, pipeline, reduced = _depth(reps, pipeline, max(1, S // 64), 16)
    ppo = PPOConfig(num_envs=min(E, 2048), horizon=64, num_agents=num_agents,
                    policy_arch=arch)
    train_step, init_fn, _ = make_ppo(ppo, device=device)
    carry = list(init_fn(ppo.seed))
    gen = torch.Generator(device=device).manual_seed(0)

    def iteration():
        nonlocal carry
        *carry, metrics = train_step(*carry, rng=gen)
        return metrics

    iteration()
    _sync(device)
    rates, window, _ = timed_windows(device, iteration, ppo.num_envs * ppo.horizon, reps,
                                     pipeline)
    name = "ppo_train" if arch == "mlp" else f"ppo_train_{arch}"
    return _row(name, ppo.num_envs, rates, ppo.horizon, pipeline, reps, window, reduced,
                num_agents=num_agents,
                agent_steps_per_sec=rates[len(rates) // 2] * num_agents)


CONFIGS = {
    "noncoop4": bench_noncoop4,
    "rvo4": bench_rvo4,
    "cadrl4": bench_cadrl4,
    "ga3c4": bench_ga3c4,
    "ga3c4_bf16": bench_ga3c4_bf16,
    "ga3c4_serving": bench_ga3c4_serving,
    "autoreset4": bench_autoreset4,
    "orca4": bench_orca4,
    "ppo_train": bench_ppo_train,
    "ga3c20_laser": bench_ga3c20_laser,
    "ga3c40": bench_ga3c40,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--configs", nargs="*", default=None, choices=sorted(CONFIGS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from gym_collision_avoidance_torch.core.device import card_label, resolve_device

    device = resolve_device(args.device)
    results = []
    for name, fn in CONFIGS.items():
        if args.configs is not None and name not in args.configs:
            continue
        results.append(fn(args.envs, args.steps, device=device))
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({"all": results, "device": card_label(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
