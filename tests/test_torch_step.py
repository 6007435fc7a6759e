"""One env_step of the port against ``jax.vmap(env_step)`` from identical
states: STATIC + NonCoop + external policy mixes, both moving dynamics
models and EXTERNAL dynamics, all three done modes, float64 and float32.

Discrete outputs (flags, counters, game over, sensor counts) are exact.
Floats agree to atol 1e-10 in float64 and rtol 1e-5 / atol 1e-6 in float32:
XLA's and torch's atan2/sin/cos differ by ulps, and XLA contracts some
multiply-adds into FMAs.

XLA also rewrites the max-turn-rate clip chain's ``d32 / f32(dt)`` into
``d32 * f32(1 / dt)``, one f32 ulp (1e-8 rad) off the true division that
the reference and the port do, on a few percent of inputs.  So float64
cases with max-turn-rate agents compare with the JAX package's exact route
(``strict_parity``: host-numpy dynamics and atan2), which divides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import env_reset as t_env_reset
from gym_collision_avoidance_torch import env_step as t_env_step
from gym_collision_avoidance_torch.env import batch as tbatch
from gym_collision_avoidance_torch.obs import spec as tspec
from gym_collision_avoidance_torch.harness import runner as trunner
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu import env_reset as j_env_reset
from gym_collision_avoidance_tpu import env_step as j_env_step
from gym_collision_avoidance_tpu.env import batch as jbatch
from gym_collision_avoidance_tpu.obs import spec as jspec
from gym_collision_avoidance_tpu.harness import runner as jrunner

MIX = (0, 1, 2, 3, 4, 5)  # EXTERNAL, STATIC, NONCOOP, LEARNING, LEARNING_GA3C, CARRL
TOL = {"float64": dict(rtol=1e-10, atol=1e-10), "float32": dict(rtol=1e-5, atol=1e-6)}


def _leaves(cfg, seed, E=32, A=5, policies=MIX, dynamics=(0, 0, 1, 1, 2)):
    """A batch of mid-episode states with collisions, frozen agents and
    nearly-exhausted timers."""
    rng = np.random.RandomState(seed)
    dt = cfg.np_dtype
    pos = rng.uniform(-2.5, 2.5, (E, A, 2))
    goal = rng.uniform(-4, 4, (E, A, 2))
    near = rng.rand(E, A) < 0.25
    goal[near] = pos[near] + rng.uniform(-0.15, 0.15, (near.sum(), 2))
    radius = rng.uniform(0.2, 0.5, (E, A))
    pref = rng.uniform(0.5, 1.5, (E, A))
    valid = rng.rand(E, A) > 0.1
    pid = rng.choice(policies, (E, A)).astype(np.int32)
    did = rng.choice(dynamics, (E, A)).astype(np.int32)
    leaves = tp.jax_leaves(tp.jax_batched_init(
        cfg, pos, goal, radius, pref, policy_id=pid, dynamics_id=did, valid=valid))

    def f(x):
        return np.asarray(x, dt)

    leaves["vel"] = f(rng.uniform(-1, 1, (E, A, 2)))
    leaves["speed"] = f(rng.uniform(0, 1.5, (E, A)))
    leaves["heading"] = f(rng.uniform(-np.pi, np.pi, (E, A)))
    td = rng.uniform(-0.6, 0.6, (E, A))
    td[rng.rand(E, A) < 0.3] = 0.0
    leaves["turning_dir"] = f(td)
    leaves["past_actions"] = f(rng.uniform(-1, 1, (E, A, 2, 2)))
    leaves["time_remaining"] = f(rng.uniform(0.05, 3.0, (E, A)))
    leaves["t"] = f(rng.uniform(0, 5, (E, A)))
    leaves["step_num"] = rng.randint(0, 50, (E, A)).astype(np.int32)
    for k, p in (("is_at_goal", 0.1), ("in_collision", 0.1), ("ran_out_of_time", 0.05)):
        leaves[k] = rng.rand(E, A) < p
    leaves["was_at_goal_already"] = leaves["is_at_goal"] & (rng.rand(E, A) < 0.5)
    leaves["was_in_collision_already"] = leaves["in_collision"] & (rng.rand(E, A) < 0.5)
    leaves["is_done"] = (leaves["is_at_goal"] | leaves["in_collision"]
                         | leaves["ran_out_of_time"] | ~valid)
    leaves["episode_step"] = rng.randint(0, 50, E).astype(np.int32)
    # external actions: speed and a heading change large enough for the
    # max-turn-rate clip; discrete policies read int(action[0]) in [0, 10]
    ext = np.stack([rng.uniform(0, 10.9, (E, A)), rng.uniform(-1.5, 1.5, (E, A))], -1)
    return leaves, ext


def _jax_step(jcfg, leaves, ext, sensors):
    """``vmap`` of the JAX env_step; its exact route runs host callbacks
    that do not take a vmapped ``dt``, so that one steps env by env."""
    if not jcfg.strict_parity:
        return jax.jit(jax.vmap(
            lambda s, a: j_env_step(s, a, jcfg, None, MIX, sensors)
        ))(tp.jax_state(leaves), jnp.asarray(ext))
    outs = [j_env_step(tp.jax_state({k: v[e] for k, v in leaves.items()}),
                       jnp.asarray(ext[e]), jcfg, None, MIX, sensors)
            for e in range(ext.shape[0])]
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)


@pytest.mark.parametrize("dtype,done_mode,method,max_turn_rate", [
    ("float64", "evaluate", "closest_first", False),
    ("float64", "single", "closest_last", True),
    ("float64", "learning", "time_to_impact", False),
    ("float32", "evaluate", "closest_first", True),
    ("float32", "learning", "closest_last", True),
])
def test_env_step_matches_jax(dtype, done_mode, method, max_turn_rate):
    kw = dict(dtype=dtype, done_mode=done_mode, agent_sorting_method=method)
    jcfg, tcfg = JCfg.evaluate(**kw), TCfg.evaluate(**kw)
    if max_turn_rate and dtype == "float64":
        jcfg = jcfg.replace(strict_parity=True)
    dynamics = (0, 0, 1, 1, 2) if max_turn_rate else (0, 0, 2)
    leaves, ext = _leaves(jcfg, seed=len(done_mode) + len(dtype), dynamics=dynamics)
    ext = ext.astype(dtype)
    sensors = ("other_agents_states",)

    ref = _jax_step(jcfg, leaves, ext, sensors)
    got = t_env_step(tp.convert.state_from_numpy(leaves, device=tp.DEVICE),
                     torch.from_numpy(ext), tcfg, None, MIX, sensors)

    tp.assert_states_close(got[0], ref[0], **TOL[dtype])
    names = ("obs", "rewards", "game_over", "info")
    tp.assert_tree_close(dict(zip(names, got[1:])), dict(zip(names, ref[1:])),
                         path="out", **TOL[dtype])
    # the batch exercises what the step decides
    new = tp.jax_leaves(ref[0])
    assert (new["in_collision"] & ~leaves["in_collision"]).any()
    assert (new["is_at_goal"] & ~leaves["is_at_goal"]).any()
    assert (new["ran_out_of_time"] & ~leaves["ran_out_of_time"]).any()
    assert np.asarray(ref[3]).any() and not np.asarray(ref[3]).all()


def test_batched_env_step_matches_jax():
    jcfg, tcfg = JCfg.evaluate(dtype="float64"), TCfg.evaluate(dtype="float64")
    leaves, ext = _leaves(jcfg, seed=9, dynamics=(0, 0, 2))
    sensors = ("other_agents_states",)
    ref = jax.jit(lambda s, a: jbatch.batched_env_step(s, a, jcfg, None, MIX, sensors))(
        tp.jax_state(leaves), jnp.asarray(ext))
    got = tbatch.batched_env_step(tp.convert.state_from_numpy(leaves, device=tp.DEVICE),
                                  torch.from_numpy(ext), tcfg, None, MIX, sensors)
    tp.assert_states_close(got[0], ref[0], **TOL["float64"])
    names = ("obs", "rewards", "game_over", "info")
    tp.assert_tree_close(dict(zip(names, got[1:])), dict(zip(names, ref[1:])),
                         path="out", **TOL["float64"])


def test_env_reset_and_policy_obs_match_jax():
    cfg_kw = dict(dtype="float64")
    jcfg, tcfg = JCfg(**cfg_kw), TCfg(**cfg_kw)
    leaves, _ = _leaves(jcfg, seed=3, policies=(2,))
    ref = jax.jit(jax.vmap(lambda s: j_env_reset(s, jcfg)))(tp.jax_state(leaves))
    got = t_env_reset(tp.convert.state_from_numpy(leaves, device=tp.DEVICE), tcfg)
    tp.assert_states_close(got[0], ref[0], **TOL["float64"])
    tp.assert_tree_close(got[1], ref[1], path="obs", **TOL["float64"])
    tp.assert_tree_close(tspec.flatten_policy_obs(got[1]),
                         jax.vmap(jspec.flatten_policy_obs)(ref[1]),
                         path="policy_obs", **TOL["float64"])


def test_rollout_and_episode_stats_match_jax():
    from gym_collision_avoidance_torch.core import state as tstate
    from gym_collision_avoidance_torch.scenarios import random_cases as trc

    jcfg, tcfg = JCfg.evaluate(dtype="float64"), TCfg.evaluate(dtype="float64")
    T = 150
    # random cases, whose straight lines cross (NonCoop agents collide),
    # and two envs of parallel lanes, where every agent reaches its goal
    case = trc.scenario_pool(8, 4, seed=1, side_length=4.0)
    lanes = np.array([[-3.0, 1.6 * k - 2.4, 3.0, 1.6 * k - 2.4, 1.0, 0.4]
                      for k in range(4)])
    case[6:] = lanes
    pos, goal, pref, radius = case[..., 0:2], case[..., 2:4], case[..., 4], case[..., 5]
    jst = tp.jax_batched_init(jcfg, pos, goal, radius, pref)
    jfinal, jtraj = jax.vmap(lambda s: jrunner.rollout(s, jcfg, T))(jst)
    jstats = jax.vmap(lambda tr: jrunner.episode_stats(tr, jcfg))(jtraj)
    tst = tstate.init_state(tcfg, pos, goal, radius, pref, device=tp.DEVICE)
    tfinal, ttraj = trunner.rollout(tst, tcfg, T, device=tp.DEVICE)
    tstats = trunner.episode_stats(ttraj, tcfg)
    tp.assert_states_close(tfinal, jfinal, **TOL["float64"])
    # JAX stacks [E, T, ...] under vmap; the port [T, E, ...]
    tp.assert_tree_close({k: v.transpose(0, 1) for k, v in ttraj.items()}, jtraj,
                         path="traj", **TOL["float64"])
    tp.assert_tree_close(tstats, jstats, path="stats", **TOL["float64"])
    # both outcomes occur in the batch
    assert np.asarray(jstats["all_at_goal"]).any()
    assert np.asarray(jstats["collision"]).any()


def test_unported_pieces_raise():
    from gym_collision_avoidance_torch.core import state as tstate

    cfg = TCfg(dtype="float64")
    st = tstate.init_state(cfg, np.zeros((1, 2, 2)), np.ones((1, 2, 2)),
                           np.full((1, 2), 0.3), np.ones((1, 2)), device="cpu")
    # apply_external_states is ported (tests/test_torch_harness.py holds it
    # against JAX); by default it moves only EXTERNAL-dynamics agents
    moved = tstate.apply_external_states(st, cfg, np.full((1, 2, 2), 0.5))
    assert torch.equal(moved.pos, st.pos)
    moved = tstate.apply_external_states(st, cfg, np.full((1, 2, 2), 0.5),
                                         mask=np.array([[True, False]]))
    assert moved.pos[0, 0].tolist() == [0.5, 0.5] and moved.pos[0, 1].tolist() == [0.0, 0.0]
    # static maps and the laserscan are ported; a laserscan without a map
    # or a cell list is a usage error, as in the JAX package
    with pytest.raises(ValueError, match="static_map"):
        t_env_step(st, None, cfg, sensors=("laserscan",))
    # every internal policy is ported: GA3C-CADRL (6), SA-CADRL (7) and
    # DRL-Long (9) need their weights, DRL-Long also the laserscan; an id
    # without a kernel still raises
    for pid, key in ((6, "ga3c_cadrl"), (7, "cadrl"), (9, "drl_long")):
        with pytest.raises(ValueError, match=key):
            t_env_step(st.replace(policy_id=torch.full_like(st.policy_id, pid)), None, cfg,
                       active_policies=(pid,))
    from gym_collision_avoidance_torch.models import drl_long
    with pytest.raises(ValueError, match="laserscan"):
        t_env_step(st, None, cfg, {"drl_long": drl_long.init_params(16, device="cpu")},
                   active_policies=(9,))
    with pytest.raises(NotImplementedError, match="no kernel"):
        t_env_step(st, None, cfg, active_policies=(11,))
    t_env_step(st.replace(policy_id=torch.full_like(st.policy_id, 8)), None, cfg,
               active_policies=(8,))
