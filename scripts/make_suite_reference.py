"""Write the JAX package's per-episode outcomes of the frozen evaluation
suites, the reference the PyTorch port's suite runs are held to.

Runs ``gym_collision_avoidance_tpu.harness.experiments.run_full_test_suite``
on the CPU, float32, ``EnvConfig.evaluate``, with JAX's x64 mode off (as
``scripts/run_full_test_suite.py`` leaves it), over {2, 3, 4} agents x
{CADRL, RVO, GA3C-CADRL-10} and each ``--trained`` checkpoint (registered as
``scripts/eval_trained_net.py`` registers it, under its file's stem) x the
first 500 cases of each frozen suite, and writes
``tests/data/torch_suite_jax_outcomes.json``: for each cell the per-episode
``outcome`` and ``steps`` and the ``summarize_suite`` row, plus the jax
version and the x64 flag.  It also runs ``scripts/eval_drl_long.py``'s
computation (:func:`jax_eval_drl_long`) on the ``--drl-long`` checkpoint and
writes each case's ``at_goal``, ``collision`` and ``timeout`` flags to
``tests/data/torch_drl_long_jax_outcomes.json``.  This is the only script of
the port's records that imports JAX; ``chip_smoke.py`` and
``scripts/run_full_test_suite_torch.py --reference`` read the JSON.

Usage::

    python scripts/make_suite_reference.py [--agents 2 3 4]
        [--policies CADRL RVO GA3C-CADRL-10] [--trained CKPT.npz ...]
        [--cases 500] [--out PATH] [--drl-long CKPT.npz] [--drl-long-out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_suite_jax_outcomes.json")
DRL_LONG_OUT = os.path.join(ROOT, "tests", "data", "torch_drl_long_jax_outcomes.json")
WEIGHTS = os.path.join(ROOT, "gym_collision_avoidance_torch", "models", "weights")
FLAGSHIP = os.path.join(WEIGHTS, "ppo_selfplay_10agent_tpu.npz")
DRL_LONG = os.path.join(WEIGHTS, "drl_long_2agent_rvo_tpu.npz")
# scripts/eval_drl_long.py's defaults
DRL_LONG_AGENTS, DRL_LONG_CASES, DRL_LONG_STEPS = 2, 500, 250


def jax_eval_drl_long(ckpt, agents=DRL_LONG_AGENTS, cases=DRL_LONG_CASES,
                      steps=DRL_LONG_STEPS):
    """``scripts/eval_drl_long.py:55-113``'s computation on the JAX package,
    statement for statement, returning what it prints from: ``{"at_goal",
    "collision", "timeout"}`` of agent 0 per case (numpy bool ``[E]``) and
    the final ``pos`` ``[E, A, 2]``.  Runs in the caller's x64 mode (the
    script's is off)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gym_collision_avoidance_tpu import EnvConfig
    from gym_collision_avoidance_tpu.env import autoreset
    from gym_collision_avoidance_tpu.env.batch import batched_env_step
    from gym_collision_avoidance_tpu.env.step import env_reset
    from gym_collision_avoidance_tpu.models import drl_long
    from gym_collision_avoidance_tpu.policies import registry as P
    from gym_collision_avoidance_tpu.scenarios import suites

    with np.load(ckpt) as z:
        params = {k: jnp.asarray(z[k]) for k in z.files}

    A = agents
    cfg = EnvConfig(dtype="float32", done_mode="evaluate", use_static_map=True)
    cells = jnp.zeros((0, 2), jnp.int32)
    sensors = ("laserscan",)
    keys = ("dist_to_goal", "heading_ego_frame", "pref_speed", "radius", "laserscan")

    suite = suites.load_full_test_suite(A, DRL_LONG_CASES)
    pool = jnp.asarray(np.stack(suite[:cases]), jnp.float32)
    E = pool.shape[0]
    policy_id = jnp.asarray(np.array([P.LEARNING] + [P.RVO] * (A - 1), np.int32))
    active = tuple(sorted({int(P.LEARNING), int(P.RVO)}))

    states = jax.jit(jax.vmap(lambda c: autoreset.state_from_case(cfg, c, policy_id)))(pool)
    states, obs = jax.vmap(lambda s: env_reset(s, cfg, sensors, keys, None, cells))(states)

    def act(obs):
        scal = jnp.stack([obs[k][:, 0, 0] for k in keys[:4]], axis=-1)
        scan = obs["laserscan"][:, 0] / 6.0 - 0.5
        mean, _ls, _v = drl_long.forward_actor_critic(params, scan, scal[:, 0:2], scal[:, 2:4])
        ext0 = mean.astype(jnp.float32)
        return jnp.concatenate([ext0[:, None, :], jnp.zeros((E, A - 1, 2), jnp.float32)],
                               axis=1)

    def body(carry, _):
        st, obs = carry
        st, obs, _rew, _go, _info = batched_env_step(st, act(obs), cfg, None, active, sensors,
                                                     keys, None, cells)
        return (st, obs), None

    @jax.jit
    def run(carry):
        return jax.lax.scan(body, carry, None, length=steps)

    (final, _obs), _ = run((states, obs))
    return {"at_goal": np.asarray(final.is_at_goal[:, 0]),
            "collision": np.asarray(final.was_in_collision_already[:, 0]),
            "timeout": np.asarray(final.ran_out_of_time[:, 0]),
            "pos": np.asarray(final.pos)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", nargs="+", type=int, default=[2, 3, 4])
    ap.add_argument("--policies", nargs="+", default=["CADRL", "RVO", "GA3C-CADRL-10"])
    ap.add_argument("--trained", nargs="*", default=[FLAGSHIP],
                    help="exported GA3C-architecture nets to add as policies")
    ap.add_argument("--cases", type=int, default=500)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--drl-long", default=DRL_LONG)
    ap.add_argument("--drl-long-out", default=DRL_LONG_OUT)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from gym_collision_avoidance_tpu.config import EnvConfig
    from gym_collision_avoidance_tpu.harness import experiments
    from gym_collision_avoidance_tpu.harness import registry as hreg

    policies = list(args.policies)
    for ckpt in args.trained:
        name = os.path.splitext(os.path.basename(ckpt))[0]
        hreg.register_trained_policy(name, ckpt)
        policies.append(name)
    cfg = EnvConfig.evaluate(dtype="float32")
    cells = []
    for num_agents in args.agents:
        for policy in policies:
            results = experiments.run_full_test_suite(
                policies_to_test=(policy,), num_agents_to_test=(num_agents,),
                num_test_cases=args.cases, cfg=cfg)
            df = results[(num_agents, policy)]
            row = experiments.summarize_suite(results).iloc[0].to_dict()
            summary = {k: (v if isinstance(v, str) else float(v)) for k, v in row.items()
                       if k not in ("num_agents", "policy")}
            cells.append({"num_agents": num_agents, "policy": policy, "cases": len(df),
                          "outcome": [str(o) for o in df["outcome"]],
                          "steps": [int(s) for s in df["steps"]],
                          "summary": summary})
            print(json.dumps({"num_agents": num_agents, "policy": policy, **summary}),
                  flush=True)
    meta = {"generator": "scripts/make_suite_reference.py",
            "package": "gym_collision_avoidance_tpu", "jax_version": jax.__version__,
            "x64": bool(jax.config.jax_enable_x64), "platform": "cpu", "dtype": "float32"}
    write_json(args.out, {**meta, "config": "EnvConfig.evaluate", "cells": cells})

    drl = jax_eval_drl_long(args.drl_long)
    flags = {k: [bool(v) for v in drl[k]] for k in ("at_goal", "collision", "timeout")}
    print(json.dumps({"drl_long": {k: sum(v) for k, v in flags.items()}}), flush=True)
    write_json(args.drl_long_out, {**meta, "script": "scripts/eval_drl_long.py",
                                   "ckpt": os.path.basename(args.drl_long),
                                   "agents": DRL_LONG_AGENTS, "cases": DRL_LONG_CASES,
                                   "steps": DRL_LONG_STEPS, **flags})


def write_json(path, doc):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
