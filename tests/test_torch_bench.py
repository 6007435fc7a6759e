"""The port's benchmark (``bench_torch.py``, ``scripts/bench_all_torch.py``)
on the CPU, and the paths it times against the JAX package.

* Every row of ``scripts/bench_all_torch.py`` and the headline run at a tiny
  size and report ``scripts/bench_all.py``'s and ``bench.py``'s keys, with
  the JAX rows' env arithmetic and pipeline depths (no JAX imported).
* ga3c40 (40 GA3C-CADRL agents, 19 observed, the row's first step at A = 40
  in a path): 10 ``batched_env_step`` steps of 2 envs against JAX's, float32
  with JAX's x64 off, from the same states.  Collisions, dones, counters,
  observed counts and the sensor's slot order exactly; floats within
  rtol 1e-5 / atol 1e-5 (float32 arithmetic; XLA's and torch's
  atan2/sin/cos differ by ulps).
* noncoop4 at E = 1, stepped 20 steps past its last agent's done: the
  frozen tail the fixed-scenario rows time, against JAX, at the same
  tolerances.
* autoreset4 and orca4 at E = 8 for 80 steps: ``episodes_completed`` and
  ``nan_free`` equal to JAX's ``_autoreset_serving``.
* ``bench_torch._exactness_check`` passes clean and returns ``MISMATCH``
  when one ulp of one leaf of one route changes.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import bench_torch

bench_all_torch = bench_torch.bench_all_torch
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)

# The keys of scripts/bench_all.py's rows (:86-91, :220-225, :287-291,
# :343-348), the JAX rows' divisors of the bench's env count and their
# chained dispatches a timed window.
_FIXED = {"config", "num_envs", "env_steps_per_sec", "agent_steps_per_sec", "spread_min",
          "spread_max"}
_SERVING = {"config", "num_envs", "env_steps_per_sec", "spread_min", "spread_max",
            "episodes_completed"}
JAX_ROWS = {   # name: (keys, envs divisor, pipeline)
    "noncoop4": (_FIXED, 1, 1),
    "rvo4": (_FIXED, 1, 1),
    "cadrl4": (_FIXED, 4, 2),
    "ga3c4": (_FIXED, 4, 8),
    "ga3c4_bf16": (_FIXED, 4, 8),
    "ga3c4_serving": (_SERVING, 4, 8),
    "autoreset4": (_SERVING | {"nan_free"}, 1, 4),
    "orca4": (_SERVING | {"nan_free"}, 1, 4),
    "ppo_train": (_FIXED | {"num_agents"}, 1, 16),
    "ga3c20_laser": (_FIXED, 16, 4),
    "ga3c40": (_FIXED, 32, 4),
}
# bench.py's headline line (:263-280)
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "spread_min", "spread_max",
                 "episodes_completed", "exactness_checks", "profile"}
PORT_KEYS = {"num_steps", "pipeline", "reps", "window_seconds_min", "reduced"}


def _headline():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_torch.main(["--device", "cpu", "--envs-divisor", "256", "--steps", "2"]) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [r["config"] for r in lines[:-1]] == [r[0] for r in bench_torch.PROFILE_ROWS]
    line = lines[-1]
    assert HEADLINE_KEYS | PORT_KEYS | {"device"} <= set(line), sorted(line)
    assert line["metric"] == "serving_env_steps_per_sec_4agent_noncoop_autoreset"
    assert line["exactness_checks"] == "ok" and line["device"] == "cpu"
    assert line["num_envs"] == 16384 // 256 and line["episodes_completed"] >= 0
    assert line["spread_min"] <= line["value"] <= line["spread_max"]
    assert line["vs_baseline"] == line["value"] / 1438.0
    assert sorted(line["profile"]) == sorted(r[0] for r in bench_torch.PROFILE_ROWS)
    assert all(isinstance(v, float) and v > 0 for v in line["profile"].values()), line
    assert line["reduced"] == ["num_envs 16384 -> 64", "num_steps 1024 -> 2"]
    assert (line["reps"], line["pipeline"]) == (5, 8)


@pytest.mark.parametrize("name", sorted(JAX_ROWS) + ["headline"])
def test_rows_report_the_jax_rows_keys(name):
    """Each row at E = 32, S = 2, one window of one dispatch on the CPU:
    the JAX row's keys and env arithmetic, finite rates, and its cuts."""
    if name == "headline":
        return _headline()
    keys, divisor, pipeline = JAX_ROWS[name]
    row = bench_all_torch.CONFIGS[name](32, 2, device="cpu", reps=1, pipeline=1)
    assert keys | PORT_KEYS <= set(row), sorted(row)
    assert row["config"] == name and row["num_envs"] == 32 // divisor
    assert 0 < row["spread_min"] <= row["env_steps_per_sec"] <= row["spread_max"] < np.inf
    if "agent_steps_per_sec" in row:
        agents = 2 if name == "ppo_train" else 40 if name == "ga3c40" else (
            20 if name == "ga3c20_laser" else 4)
        assert row["agent_steps_per_sec"] == row["env_steps_per_sec"] * agents
    if "nan_free" in row:
        assert row["nan_free"] is True
    reps_cut = [] if name == "ppo_train" else ["reps 3 -> 1"]   # ppo: S // 64 windows
    assert row["reduced"] == reps_cut + ([f"pipeline {pipeline} -> 1"] if pipeline > 1 else [])
    assert (row["reps"], row["pipeline"]) == (1, 1)


def test_a_failing_row_fails_the_run(monkeypatch):
    """A row that raises is printed as an error row, the headline still
    comes last, and ``main`` returns 1."""
    def broken(*args, **kwargs):
        raise RuntimeError("pairwise_rewards kernel launch failed: cudaError 209")

    monkeypatch.setattr(bench_all_torch, "bench_cadrl4", broken)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_torch.main(["--device", "cpu", "--envs-divisor", "256", "--steps", "2"])
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert rc == 1
    assert "cudaError 209" in lines[1]["error"] and lines[1]["config"] == "cadrl4"
    assert lines[-1]["metric"] == "serving_env_steps_per_sec_4agent_noncoop_autoreset"
    assert "cudaError 209" in lines[-1]["profile"]["cadrl4"]


def test_rows_without_cuts_run_the_jax_depth():
    """With no override a row runs the JAX row's windows and pipeline and
    lists no cut."""
    row = bench_all_torch.CONFIGS["cadrl4"](8, 1, device="cpu")
    assert (row["reps"], row["pipeline"], row["reduced"]) == (3, 2, [])


# ------------------------------------------------------- against the JAX package

def _jax_fixed_run(row, E, steps):
    """JAX's ``bench_config`` row ``row`` (scripts/bench_all.py) at E envs,
    float32 with x64 off: the state after each step as numpy leaves, and
    each step's (obs, rewards, game_over, info)."""
    import jax
    import jax.numpy as jnp

    import _torch_parity as tp
    from gym_collision_avoidance_tpu import EnvConfig
    from gym_collision_avoidance_tpu.env.batch import batched_env_step
    from gym_collision_avoidance_tpu.models import ga3c_cadrl
    from gym_collision_avoidance_tpu.scenarios import presets

    with jax.enable_x64(False):
        if row == "ga3c40":
            cfg = EnvConfig(dtype="float32", max_num_other_agents_observed=19,
                            agent_sorting_method="closest_last")
            sc = presets.circle_scenario(40, radius=10.0, agent_radius=0.3, policy="GA3C_CADRL")
            params = {"ga3c_cadrl": ga3c_cadrl.load_params()}
        else:
            cfg = EnvConfig(dtype="float32")
            sc = presets.circle_scenario(4, radius=3.0, agent_radius=0.5)
            params = None
        state = jax.tree.map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), sc.to_state(cfg))
        step = jax.jit(lambda s: batched_env_step(s, None, cfg, params, sc.active_policies,
                                                  ("other_agents_states",), ("dist_to_goal",)))
        states, outs = [tp.jax_leaves(state)], []
        for _ in range(steps):
            state, obs, rew, go, info = step(state)
            states.append(tp.jax_leaves(state))
            outs.append(jax.device_get((obs, rew, go, info)))
    return states, outs


def _slot_order(port, ref):
    """For every (env, ego, slot) the slot of ``ref``'s sensor rows
    (``[E, A, K, 7]``) nearest to ``port``'s row: the identity when both
    order the observed agents alike."""
    d = np.abs(port[:, :, :, None, :] - ref[:, :, None, :, :]).sum(-1)
    return np.argmin(d, axis=-1)


def _hold_fixed_steps(row, E, ref_states, ref_outs):
    """Step the port's fixed row from JAX's initial states and hold every
    step against JAX's."""
    import _torch_parity as tp
    from gym_collision_avoidance_torch import convert
    from gym_collision_avoidance_torch.harness import paths

    path = paths.fixed_row(row, "cpu")
    # the port's row builds JAX's initial states
    tp.assert_tree_close(convert.state_to_numpy(path.states(E, "cpu")), ref_states[0], 0, 0,
                         "init")
    state = convert.state_from_numpy(ref_states[0], device="cpu")
    for t, (want, (obs, rew, go, info)) in enumerate(zip(ref_states[1:], ref_outs)):
        state, tobs, trew, tgo, tinfo = path.step(state)
        tp.assert_tree_close({"obs": tobs, "rewards": trew, "game_over": tgo, "info": tinfo},
                             {"obs": obs, "rewards": rew, "game_over": go, "info": info},
                             path=f"step{t}", **TOL)
        got = convert.state_to_numpy(state)
        tp.assert_tree_close(got, want, path=f"step{t}/state", **TOL)
        K = want["sensed_others"].shape[2]
        seen = np.arange(K) < want["num_other_agents_observed"][..., None]
        order = _slot_order(got["sensed_others"], want["sensed_others"])
        np.testing.assert_array_equal(np.where(seen, order, -1),
                                      np.where(seen, np.arange(K), -1), err_msg=f"step{t}")
    return state


def test_ga3c40_path_matches_jax():
    """bench_all.py's ga3c40 row: 2 envs, 10 steps, every agent seeing 19
    of its 39 neighbours, against JAX's ``batched_env_step``."""
    E, T = 2, 10
    ref_states, ref_outs = _jax_fixed_run("ga3c40", E, T)
    state = _hold_fixed_steps("ga3c40", E, ref_states, ref_outs)
    assert (state.num_other_agents_observed == 19).all() and (state.speed > 0).all()


def test_noncoop4_frozen_tail_matches_jax():
    """noncoop4 at E = 1 until every agent is done, then 20 more steps: the
    frozen states the fixed rows keep stepping stay JAX's."""
    ref_states, ref_outs = _jax_fixed_run("noncoop4", 1, 200)
    last_done = next(t for t, o in enumerate(ref_outs)
                     if bool(np.all(o[3]["which_agents_done"])))
    T = last_done + 1 + 20
    state = _hold_fixed_steps("noncoop4", 1, ref_states[:T + 1], ref_outs[:T])
    assert state.is_done.all() and last_done >= 10
    # frozen: positions and headings stay those of the first all-done state,
    # the velocities zero from the step after it on
    for leaves in ref_states[last_done + 2:T + 1]:
        for k in ("pos", "heading", "is_done"):
            np.testing.assert_array_equal(leaves[k], ref_states[last_done + 1][k])
        assert not leaves["vel"].any()


def _jax_bench_all():
    spec = importlib.util.spec_from_file_location("bench_all",
                                                  os.path.join(ROOT, "scripts", "bench_all.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,policy", [("autoreset4", 2), ("orca4", 8)])
def test_autoreset_rows_match_jax(name, policy):
    """E = 8, S = 16, one window of 4 dispatches: 80 auto-reset steps, the
    episode count and NaN-freedom of JAX's ``_autoreset_serving``."""
    import jax

    with jax.enable_x64(False):
        want = _jax_bench_all()._autoreset_serving(name, policy, 8, 16, reps=1)
    got = bench_all_torch.CONFIGS[name](8, 16, device="cpu", reps=1)
    assert (got["pipeline"], got["num_steps"]) == (4, 16)
    assert got["episodes_completed"] == want["episodes_completed"] > 0
    assert got["nan_free"] is want["nan_free"] is True


def _nudge(route, leaf):
    """Move one entry of ``leaf`` of ``route`` by one ulp (one count for an
    int leaf)."""
    x = route["state"]["pos"] if leaf == "state" else route[leaf]
    flat = x.view(-1)
    if x.is_floating_point():
        flat[0] = torch.nextafter(flat[0], torch.tensor(np.inf, dtype=x.dtype))
    else:
        flat[0] += 1


@pytest.mark.parametrize("leaf", [None, "state", "counters", "logit_sums"])
def test_exactness_check_trips_on_one_ulp(leaf):
    """The tripwire's comparison: clean it passes; one ulp of the state's
    ``pos``, one count of the counters or one ulp of a step's logit sum,
    on either route, and it returns ``MISMATCH``."""
    for route in ("kernels", "plain"):
        tamper = None if leaf is None else (lambda finals: _nudge(finals[route], leaf))
        got = bench_torch._exactness_check("cpu", num_envs=4, num_steps=6, tamper=tamper)
        if leaf is None:
            assert got == "ok"
            break
        assert got.startswith("MISMATCH: ") and (leaf.split("_")[0] in got), got
