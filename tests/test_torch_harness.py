"""The port's evaluation harness against the JAX package's, on the CPU.

* ``scenarios.suites``: every vendored pickle loads to the JAX package's
  arrays bitwise, and so does ``preset_test_cases(n)`` for every ``n`` the
  JAX function takes.
* ``harness.experiments``: 3-agent RVO episodes ending at the goal, in
  collisions and stuck, against JAX's (trajectories too), ``summarize_stats``
  against JAX's ``summarize_suite``; chunk size and batch composition leave
  every episode's stats bitwise unchanged.  ``tests/test_torch_suite_f64.py``
  and ``tests/test_torch_suite_f32.py`` hold the first 8 cases of the 2- and
  4-agent suites against JAX.
* ``harness.registry``: all 14 specs and their configs, the six GA3C
  checkpoints copied from the JAX package, ``register_trained_policy``.
* ``obs.wrappers.ObsLayout``, ``core.state.apply_external_states``, the two
  dataset campaigns, and ``harness.visualize.plot_episode``'s PNG bytes.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import convert
from gym_collision_avoidance_torch.core import dynamics as tdyn
from gym_collision_avoidance_torch.core import state as tstate
from gym_collision_avoidance_torch.env.step import env_reset as t_env_reset
from gym_collision_avoidance_torch.harness import datasets as tdata
from gym_collision_avoidance_torch.harness import experiments as tx
from gym_collision_avoidance_torch.harness import registry as treg
from gym_collision_avoidance_torch.harness import stats as tstats
from gym_collision_avoidance_torch.harness import visualize as tvis
from gym_collision_avoidance_torch.models import ga3c_cadrl as tga3c
from gym_collision_avoidance_torch.obs.wrappers import ObsLayout as TLayout
from gym_collision_avoidance_torch.scenarios import presets as tpresets
from gym_collision_avoidance_torch.scenarios import suites as tsuites
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu.core import state as jstate
from gym_collision_avoidance_tpu.env.step import env_reset as j_env_reset
from gym_collision_avoidance_tpu.harness import datasets as jdata
from gym_collision_avoidance_tpu.harness import experiments as jx
from gym_collision_avoidance_tpu.harness import registry as jreg
from gym_collision_avoidance_tpu.harness import stats as jstats
from gym_collision_avoidance_tpu.harness import visualize as jvis
from gym_collision_avoidance_tpu.obs.wrappers import ObsLayout as JLayout
from gym_collision_avoidance_tpu.scenarios import presets as jpresets
from gym_collision_avoidance_tpu.scenarios import suites as jsuites

CPU = tp.DEVICE
CELL_POLICIES = ("RVO", "GA3C-CADRL-10", "CADRL")
DISCRETE = ("steps", "outcome", "collision", "all_at_goal", "any_stuck", "num_agents")
FLOATS = ("total_reward", "time_to_goal", "total_time_to_goal", "extra_time_to_goal")
# per dtype, the episode stats' floats.  The clocks are sums of dt and come
# out equal; the reward sums carry each step's getting-close term, which
# follows the trajectory.  Measured: every float32 episode of the 8-case
# cells within 3.1e-6 but one (DEADLOCK_TOL), every float64 one within 1.5e-13.
FLOAT_TOL = {"float64": dict(rtol=1e-9, atol=1e-9), "float32": dict(rtol=1e-5, atol=1e-5)}
# In float32, case 1 of the 4-agent suite under RVO is a 304-step deadlock
# whose positions drift apart by 4e-3 by its end (from 2e-6 at step 50),
# which moves its reward sums (-13.7 to -15.9) by 1.6e-4 of their size: that
# episode alone is held to this limit.
DEADLOCK_TOL = {(4, "RVO", 1): dict(rtol=1e-3, atol=1e-5)}


def _jax_scenarios(num_agents, policy, n):
    spec = jreg.POLICY_SPECS[policy]
    return [jpresets.Scenario(pos=c[:, 0:2], goal=c[:, 2:4], pref_speed=c[:, 4],
                              radius=c[:, 5],
                              policy_id=np.full(num_agents, spec.policy_id, np.int32))
            for c in jsuites.preset_test_cases(num_agents, full_test_suite=True)[:n]]


def _jax_cell(num_agents, policy, dtype, n):
    """JAX's stats of the cell's first ``n`` cases (x64 off for float32)."""
    def run():
        cfg = jreg.cfg_for_policy(policy, JCfg.evaluate(dtype=dtype))
        spec = jreg.POLICY_SPECS[policy]
        params = jreg.load_params(*spec.needs_params) if spec.needs_params else None
        return jx.run_batched_episodes(_jax_scenarios(num_agents, policy, n), cfg, params)

    if dtype == "float32":
        with jax.enable_x64(False):
            return run()
    return run()


def _assert_stats_equal(got, want, tol=None, tol_of_episode=None):
    """Per-episode stats: discrete entries equal; floats bitwise, or to
    ``tol`` where given (``tol_of_episode[i]`` for episode ``i`` if there)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        tol_i = (tol_of_episode or {}).get(i, tol)
        assert set(g) == set(w), (i, sorted(g), sorted(w))
        for k in DISCRETE:
            assert g[k] == w[k], (i, k, g[k], w[k])
        for k in FLOATS:
            gk, wk = np.asarray(g[k]), np.asarray(w[k])
            assert gk.shape == wk.shape and gk.dtype == wk.dtype, (i, k, gk.dtype, wk.dtype)
            if tol_i is None:
                np.testing.assert_array_equal(gk, wk, err_msg=f"episode {i} {k}")
            else:
                np.testing.assert_allclose(gk, wk, **tol_i, err_msg=f"episode {i} {k}")


# ------------------------------------------------------------------ suites


def test_outcome_str_and_preset_two_agent_cases():
    for c in (False, True):
        for g in (False, True):
            assert tstats.outcome_str(c, g) == jstats.outcome_str(c, g)
    got, want = tpresets.preset_two_agent_cases(), jpresets.preset_two_agent_cases()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


_PICKLES = [
    (dict(num_agents=n), f"{n}_agents_500_cases.p") for n in (2, 3, 4, 5, 6, 8, 10)
] + [
    (dict(num_agents="2_3_4"), "2_3_4_agents_500_cases.p"),
    (dict(num_agents=2, carrl=True), "2_agents_500_cases_carrl.p"),
] + [
    (dict(num_agents=2, carrl=True, seed=s), f"2_agents_500_cases_carrl_seed{s:03d}.p")
    for s in range(5)
]


def test_every_vendored_pickle_loads_to_jax_arrays():
    names = sorted(f for f in os.listdir(tsuites.VENDORED_TEST_CASE_DIR) if f.endswith(".p"))
    assert names == sorted(f for _, f in _PICKLES)
    for kwargs, fname in _PICKLES:
        got, want = tsuites.load_full_test_suite(**kwargs), jsuites.load_full_test_suite(**kwargs)
        assert len(got) == len(want), fname
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=fname)
        assert filecmp.cmp(os.path.join(tsuites.VENDORED_TEST_CASE_DIR, fname),
                           os.path.join(jsuites._VENDORED_TEST_CASE_DIR, fname), shallow=False)
    with pytest.raises(FileNotFoundError):
        tsuites.load_full_test_suite(7)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 10, 20])
def test_preset_test_cases_match_jax(n):
    got, want = tsuites.preset_test_cases(n), jsuites.preset_test_cases(n)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsuites.preset_test_cases(7)


def test_formations_and_yaml_match_jax():
    for letter in tsuites.FORMATION_LETTERS:
        got = tsuites.formation_goals(letter, 6, np.random.RandomState(3))
        want = jsuites.formation_goals(letter, 6, np.random.RandomState(3))
        np.testing.assert_array_equal(got, want)
    pos = np.arange(12.0).reshape(6, 2)
    got = tsuites.formation_scenario(pos, "R", rng=np.random.RandomState(4))
    want = jsuites.formation_scenario(pos, "R", rng=np.random.RandomState(4))
    items = [{"a": dict(start_x=0.0, start_y=1.0, goal_x=2.0, goal_y=3.0, policy="RVO",
                        dynamics="unicycle")},
             {"b": dict(start_x=4.0, start_y=5.0, goal_x=6.0, goal_y=7.0, policy="noncoop",
                        dynamics="external")}]
    for g, w in ((got, want), (tsuites.yaml_scenario(items), jsuites.yaml_scenario(items))):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            assert (a is None) == (b is None), f.name
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f.name)


# ------------------------------------------------------------- experiments


@pytest.mark.parametrize("policy", CELL_POLICIES)
def test_stats_do_not_depend_on_chunks_or_batch(policy):
    """Bitwise: chunks of 128, 50 and 7 steps; cases 1, 4 and 6 run as their
    own batch give the stats they have inside the 8-case batch."""
    scenarios, cfg, params = tx.suite_cell(4, policy, 8, device=CPU)
    full = tx.run_batched_episodes(scenarios, cfg, params, device=CPU)
    for chunk in (50, 7):
        run = tx.run_episode_batch(scenarios, cfg, params, chunk_steps=chunk, device=CPU)
        _assert_stats_equal(run.stats, full)
        longest = max(s["steps"] for s in full)
        assert run.lockstep_steps % chunk == 0 and 0 <= run.lockstep_steps - longest < chunk
    subset = [1, 4, 6]
    alone = tx.run_batched_episodes([scenarios[i] for i in subset], cfg, params, device=CPU)
    _assert_stats_equal(alone, [full[i] for i in subset])


# cases of the 3-agent suite that end in collisions (18, 131), stuck (109,
# 251) and at the goal (0, 1) under RVO, run as one batch
MIXED_CASES = (0, 1, 18, 131, 109, 251)


def test_trajectories_and_summaries_match_jax():
    """3-agent RVO in float64 on ``MIXED_CASES`` with
    ``collect_trajectories``: positions to 1e-9; ``summarize_stats`` on the
    port's stats against JAX's ``summarize_suite`` on its own, and the
    port's ``summarize_suite``."""
    import pandas as pd

    cfg = TCfg.evaluate(dtype="float64")
    stats, traj = tx.run_batched_episodes(
        [tx.suite_scenarios(3, "RVO", 500)[i] for i in MIXED_CASES], cfg,
        collect_trajectories=True, device=CPU)
    want, jtraj = jx.run_batched_episodes(
        [_jax_scenarios(3, "RVO", 500)[i] for i in MIXED_CASES],
        JCfg.evaluate(dtype="float64"), collect_trajectories=True)
    _assert_stats_equal(stats, want, FLOAT_TOL["float64"])
    assert [s["outcome"] for s in stats] == ["all_at_goal"] * 2 + ["collision"] * 2 + ["stuck"] * 2
    assert traj.shape == jtraj.shape and traj.dtype == jtraj.dtype
    np.testing.assert_allclose(traj, jtraj, rtol=0, atol=1e-9)

    df = pd.DataFrame([{"test_case": i, "policy_id": "RVO", **s} for i, s in enumerate(want)])
    ref = jx.summarize_suite({(3, "RVO"): df}).iloc[0]
    summary = tx.summarize_stats(stats)
    for k in ("pct_collision", "pct_stuck", "pct_success"):
        assert summary[k] == ref[k], k
    for k in ("mean_extra_time_to_goal", "p90_extra_time_to_goal"):
        np.testing.assert_allclose(summary[k], ref[k], rtol=1e-9)
    tdf = pd.DataFrame([{"test_case": i, "policy_id": "RVO", **s} for i, s in enumerate(stats)])
    row = tx.summarize_suite({(3, "RVO"): tdf}).iloc[0]
    assert (row["num_agents"], row["policy"]) == (3, "RVO")
    for k, v in summary.items():
        assert row[k] == v, k


def test_outcome_records_and_lockstep_steps():
    stats = [{"outcome": o, "steps": s, "collision": o == "collision",
              "any_stuck": o == "stuck", "extra_time_to_goal": np.array([0.5, 1.0])}
             for o, s in (("all_at_goal", 60), ("collision", 300), ("stuck", 129))]
    rec = tx.cell_record(3, "RVO", stats)
    assert rec["outcome"] == ["all_at_goal", "collision", "stuck"] and rec["steps"][2] == 129
    same = tx.compare_outcomes(rec, rec)
    assert same["ok"] and same["outcome_agreement"] == 1.0 and same["differing_cases"] == []
    other = dict(rec, outcome=["all_at_goal", "collision", "all_at_goal"])
    cmp = tx.compare_outcomes(rec, other)
    assert not cmp["ok"] and cmp["differing_cases"] == [2]
    # one outcome apart fails; step counts may differ on 2% of the cases
    ref = dict(rec, outcome=["all_at_goal"] * 100, steps=list(range(100)))
    for apart, ok in ((2, True), (3, False)):
        got = dict(ref, steps=[s + (i < apart) for i, s in enumerate(ref["steps"])])
        cmp = tx.compare_outcomes(ref, got)
        assert cmp["ok"] == ok and cmp["steps_apart_cases"] == list(range(apart))
    assert not tx.compare_outcomes(ref, dict(ref, outcome=["stuck"] + ref["outcome"][1:]))["ok"]
    # a record of the first cases against the whole reference cell
    ref = dict(ref, outcome=["collision"] * 10 + ref["outcome"][10:])
    first = tx.compare_outcomes(ref, dict(ref, outcome=ref["outcome"][:10],
                                          steps=ref["steps"][:10]))
    assert first["ok"] and first["cases"] == 10
    assert set(first["pct_points_apart"].values()) == {0.0}
    assert tx.compare_outcomes(rec, other)["pct_points_apart"] == {
        "pct_success": pytest.approx(100 / 3), "pct_collision": 0.0,
        "pct_stuck": pytest.approx(100 / 3)}
    with pytest.raises(ValueError):
        tx.compare_outcomes(rec, ref)
    # the steps a batch ran: whole chunks until every episode is over, or
    # max_steps rounded up to whole chunks
    scenarios, cfg, params = tx.suite_cell(2, "RVO", 2, device=CPU)
    run = tx.run_episode_batch(scenarios, cfg, params, chunk_steps=16, device=CPU)
    longest = max(s["steps"] for s in run.stats)
    assert run.lockstep_steps % 16 == 0 and 0 <= run.lockstep_steps - longest < 16
    assert tx.run_episode_batch(scenarios, cfg, params, chunk_steps=2, max_steps=5,
                                device=CPU).lockstep_steps == 6


# ----------------------------------------------------------------- registry


def test_policy_specs_and_configs_match_jax():
    """The JAX package's fourteen specs, then the port's own SARL."""
    assert list(treg.POLICY_SPECS) == list(jreg.POLICY_SPECS) + ["SARL"]
    assert len(jreg.POLICY_SPECS) == 14
    assert treg.POLICY_SPECS["SARL"].policy_id == 10
    base_t, base_j = TCfg.evaluate(dtype="float32"), JCfg.evaluate(dtype="float32")
    shared = {f.name for f in dataclasses.fields(base_t)} & {
        f.name for f in dataclasses.fields(base_j)}
    for name in jreg.POLICY_SPECS:
        spec = treg.POLICY_SPECS[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(jreg.POLICY_SPECS[name]), name
        ct, cj = treg.cfg_for_policy(name, base_t), jreg.cfg_for_policy(name, base_j)
        for field in shared:
            assert getattr(ct, field) == getattr(cj, field), (name, field)


def test_all_specs_load_on_the_cpu():
    for name, spec in treg.POLICY_SPECS.items():
        params = treg.load_params(*spec.needs_params, device=CPU) if spec.needs_params else {}
        for module in params.values():
            assert all(t.device.type == "cpu" for t in module.state_dict().values()), name
    assert treg.load_params("cadrl", device=CPU, dtype="float64")["cadrl"].dtype == torch.float64
    with pytest.raises(KeyError):
        treg.load_params("nope", device=CPU)


@pytest.mark.parametrize("key", ["ga3c_cadrl:20190727_015942", "ga3c_cadrl:20190727_192048",
                                 "ga3c_cadrl:ppo_selfplay_2agent",
                                 "ga3c_cadrl:ppo_selfplay_6agent_curr",
                                 "ga3c_cadrl:ppo_selfplay_10agent_curr",
                                 "ga3c_cadrl:ppo_selfplay_10agent_tpu",
                                 "ga3c_cadrl:iros18:bf16"])
def test_ga3c_checkpoints_match_jax(key):
    name = key.split(":")[1]
    port_file, jax_file = tga3c.CHECKPOINTS[name], tga3c.CHECKPOINTS[name].replace(
        "gym_collision_avoidance_torch", "gym_collision_avoidance_tpu")
    assert filecmp.cmp(port_file, jax_file, shallow=False)
    got = treg.load_params(key, device=CPU)["ga3c_cadrl"]
    want = convert.ga3c_params_from_numpy(
        jax.device_get(jreg.load_params(key)["ga3c_cadrl"]), device=CPU)
    assert got.dtype == want.dtype == (torch.bfloat16 if key.endswith("bf16") else torch.float32)
    for (k, a), (k2, b) in zip(got.state_dict().items(), want.state_dict().items()):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.parametrize("ckpt, slots", [("ppo_selfplay_2agent", 3), ("iros18", 19)])
def test_register_trained_policy_width_rule(ckpt, slots):
    path = tga3c.CHECKPOINTS[ckpt]
    name = f"test-trained-{ckpt}"
    try:
        treg.register_trained_policy(name, path)
        jreg.register_trained_policy(name, path)
        spec = treg.POLICY_SPECS[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(jreg.POLICY_SPECS[name])
        assert spec.max_num_other_agents_observed == slots
        assert spec.agent_sorting_method == "closest_first"
        net = treg.load_params(*spec.needs_params, device=CPU)["ga3c_cadrl"]
        assert net.width == 5 + 7 * slots
    finally:
        treg.POLICY_SPECS.pop(name, None)
        jreg.POLICY_SPECS.pop(name, None)


# ------------------------------------------------------------------ wrappers


def test_obs_layout_round_trip_and_flat_order_match_jax():
    cfg = TCfg.evaluate(dtype="float64")
    E, A = 3, 4
    scenarios = [tpresets.circle_scenario(A, radius=3.0 + e) for e in range(E)]
    _, obs = t_env_reset(tx.stack_scenarios(scenarios, cfg, CPU), cfg)
    layout = TLayout.from_obs(obs, list(obs))
    arr = layout.to_array(obs)
    assert arr.shape == (E, A, layout.agent_size)
    flat = layout.to_flat(obs)
    assert flat.shape == (E, A * layout.agent_size)
    back = layout.to_dict(arr)
    for k in obs:
        assert torch.equal(back[k], obs[k]), k
    lo, hi = layout.agent_slice(2)
    assert torch.equal(flat[:, lo:hi], arr[:, 2])
    for e in range(E):
        obs_e = {k: jnp.asarray(v[e].numpy()) for k, v in obs.items()}
        jl = JLayout.from_obs(obs_e, list(obs_e))
        assert (jl.slices, jl.shapes, jl.agent_size) == (layout.slices, layout.shapes,
                                                         layout.agent_size)
        np.testing.assert_array_equal(flat[e].numpy(), np.asarray(jl.to_flat(obs_e)))
        np.testing.assert_array_equal(arr[e].numpy(), np.asarray(jl.to_array(obs_e)))
    # the JAX package's obs, built by its own reset, in the same order
    jstate0, jobs = j_env_reset(jpresets.circle_scenario(A, radius=3.0).to_state(
        JCfg.evaluate(dtype="float64")), JCfg.evaluate(dtype="float64"))
    np.testing.assert_allclose(flat[0].numpy(), np.asarray(JLayout.from_obs(
        jobs, list(obs)).to_flat(jobs)), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------- external states


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_apply_external_states_matches_jax(dtype):
    """Two envs of 2 agents, agent 0 EXTERNAL dynamics: at ``step_num`` 0 the
    velocity is zero, at 1 the position change over dt (a true division in
    both packages, so equal bits); headings to 1e-12 / 1e-6."""
    tcfg, jcfg = TCfg(dtype=dtype), JCfg(dtype=dtype)
    rng = np.random.RandomState(0)
    E, A = 2, 2
    pos, goal = rng.uniform(-3, 3, (E, A, 2)), rng.uniform(-3, 3, (E, A, 2))
    radius, speed = np.full((E, A), 0.3), np.ones((E, A))
    dyn_id = np.array([[tdyn.EXTERNAL, tdyn.UNICYCLE]] * E, np.int32)
    pid = np.zeros((E, A), np.int32)
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == "float64" else dict(rtol=1e-6, atol=1e-6)

    def jax_side(fn):
        if dtype == "float32":
            with jax.enable_x64(False):
                return fn()
        return fn()

    st = tstate.init_state(tcfg, pos, goal, radius, speed, heading=np.zeros((E, A)),
                           policy_id=pid, dynamics_id=dyn_id, device=CPU)
    jsts = jax_side(lambda: [jstate.init_state(jcfg, pos[e], goal[e], radius[e], speed[e],
                                               np.zeros(A), pid[e], dyn_id[e]) for e in range(E)])
    for step_num, new_pos in ((0, pos + 0.37), (1, pos + np.array([0.41, -0.13]))):
        st = st.replace(step_num=torch.full((E, A), step_num, dtype=torch.int32))
        st = tstate.apply_external_states(st, tcfg, new_pos)

        def jax_apply():
            out = []
            for e in range(E):
                js = jsts[e].replace(step_num=jnp.full((A,), step_num, jnp.int32))
                out.append(jstate.apply_external_states(js, jcfg, new_pos[e]))
            return out

        jsts = jax_side(jax_apply)
        for e in range(E):
            for leaf in ("pos", "vel", "speed"):
                np.testing.assert_array_equal(getattr(st, leaf)[e].numpy(),
                                              np.asarray(getattr(jsts[e], leaf)), err_msg=leaf)
            for leaf in ("heading", "delta_heading"):
                np.testing.assert_allclose(getattr(st, leaf)[e].numpy(),
                                           np.asarray(getattr(jsts[e], leaf)), **tol,
                                           err_msg=leaf)
        assert bool((st.vel[:, 0] != 0).all()) == (step_num == 1)
        assert bool((st.pos[:, 1] == torch.as_tensor(pos[:, 1], dtype=st.pos.dtype)).all())


# ------------------------------------------------------------------ datasets


def test_collect_regression_dataset_matches_jax():
    got = tdata.collect_regression_dataset(40, device=CPU)
    want = jdata.collect_regression_dataset(40)
    for g, w, tol in zip(got, want, (1e-12, 1e-9, 1e-9)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


def test_collect_trajectory_dataset_matches_jax():
    got, want = tdata.collect_trajectory_dataset(2, device=CPU), jdata.collect_trajectory_dataset(2)
    assert [len(t) for t in got] == [len(t) for t in want]
    for gt, wt in zip(got, want):
        for g, w in zip(gt, wt):
            assert set(g) == set(w)
            for k in w:
                if k == "pedestrian_state":
                    for kk in w[k]:
                        np.testing.assert_allclose(g[k][kk], w[k][kk], rtol=1e-9, atol=1e-9)
                else:
                    # omega divides a heading change by dt: ulps of atan2 / 0.1
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-8, atol=1e-8, err_msg=k)


# ----------------------------------------------------------------- plotting


def test_plot_episode_png_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    positions = np.cumsum(rng.uniform(-0.1, 0.1, (30, 3, 2)), axis=0)
    radii, goals = np.array([0.3, 0.4, 0.5]), rng.uniform(-1, 1, (3, 2))
    paths = []
    for vis, tag in ((tvis, "port"), (jvis, "jax")):
        path = str(tmp_path / tag / "episode.png")
        vis.plot_episode(positions, radii, goals=goals, dt=0.1, save_path=path,
                         in_collision=np.array([False, True, False]), title="swap")
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert os.path.exists(str(tmp_path / "port" / "collisions" / "episode.png"))
