"""The laser slice end to end on the CPU: the port's ``env_step`` with the
laserscan sensor and wall collisions against ``jax.vmap(env_step)``, and
its auto-reset loop against the JAX package's
``make_autoreset_step(return_info=True)``, in float64.

Discrete outputs (flags, counters, game over, sensor counts, the exactness
guard) are exact, and so are the laserscan ranges and histories.  Other
floats agree to atol 1e-10 in a single step and 1e-9 along the loop (XLA's
and torch's atan2/sin/cos differ by ulps, which a trajectory carries
forward).  A 100-step float32 serving run stays free of NaNs.
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
from gym_collision_avoidance_torch.env import autoreset as tauto
from gym_collision_avoidance_torch.env import batch as tbatch
from gym_collision_avoidance_torch.harness.serving import AutoresetServer as TServer
from gym_collision_avoidance_torch.maps import grid as tgrid
from gym_collision_avoidance_torch.scenarios import random_cases as trc
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu import env_reset as j_env_reset
from gym_collision_avoidance_tpu import env_step as j_env_step
from gym_collision_avoidance_tpu.env import autoreset as jauto

NONCOOP, STATIC = 2, 1
OBS = ("num_other_agents", "dist_to_goal", "heading_ego_frame", "radius",
       "other_agents_states", "laserscan")
FAST = dict(laserscan_entry_window=12, laserscan_beam_slots=4)


def _cfgs(dtype, **kw):
    kw = dict(dtype=dtype, use_static_map=True, map_x_width=10.0, map_y_width=10.0,
              laserscan_length=128, laserscan_num_past=3, **kw)
    return JCfg(**kw), TCfg(**kw)


def _maps(with_map=True):
    static = tgrid.load_static_map(TCfg(map_x_width=10.0, map_y_width=10.0),
                                   tgrid.world_map_path("002") if with_map else None)
    return static, tgrid.occupied_cell_list(static, int(static.sum()) + 5)


def _leaves(cfg, seed, E=6, A=5):
    """Mid-episode states around the 002 obstacle: some agents on it, some
    sensing for the first time, some with a history."""
    rng = np.random.RandomState(seed)
    dt = cfg.np_dtype
    pos = rng.uniform(-2.5, 2.5, (E, A, 2))
    pos[:, 0] = rng.uniform(-0.6, 0.6, (E, 2))
    goal = rng.uniform(-4, 4, (E, A, 2))
    radius = rng.uniform(0.2, 0.3, (E, A))
    valid = rng.rand(E, A) > 0.1
    pid = rng.choice((NONCOOP, STATIC), (E, A)).astype(np.int32)
    leaves = tp.jax_leaves(tp.jax_batched_init(cfg, pos, goal, radius, np.ones((E, A)),
                                               policy_id=pid, valid=valid))
    leaves["vel"] = rng.uniform(-1, 1, (E, A, 2)).astype(dt)
    leaves["heading"] = rng.uniform(-np.pi, np.pi, (E, A)).astype(dt)
    count = rng.randint(0, 3, (E, A)).astype(np.int32)
    hist = rng.uniform(0.5, 6.0, leaves["laserscan_history"].shape).astype(dt)
    leaves["laserscan_history"] = np.where(count[..., None, None] > 0, hist, 0.0).astype(dt)
    leaves["laserscan_count"] = count
    leaves["in_collision"] = rng.rand(E, A) < 0.1
    leaves["is_done"] = leaves["in_collision"] | ~valid
    return leaves


@pytest.mark.parametrize("route,laser,with_cells", [
    ("full", "laserscan", True),
    ("fast", ("laserscan", (0, 2, 3)), True),
    ("dense", "laserscan", False),
])
def test_env_step_with_laser_and_walls_matches_jax(route, laser, with_cells):
    jcfg, tcfg = _cfgs("float64", **(FAST if route == "fast" else {}))
    static, cells = _maps()
    leaves = _leaves(jcfg, seed=len(route))
    sensors = ("other_agents_states", laser)
    jcells = jnp.asarray(cells) if with_cells else None
    ref = jax.jit(jax.vmap(lambda s: j_env_step(
        s, None, jcfg, None, (NONCOOP, STATIC), sensors, OBS, jnp.asarray(static), jcells)))(
            tp.jax_state(leaves))
    got = t_env_step(tp.convert.state_from_numpy(leaves, device=tp.DEVICE), None, tcfg, None,
                     (NONCOOP, STATIC), sensors, OBS, static, cells if with_cells else None)
    tol = dict(rtol=1e-10, atol=1e-10)
    tp.assert_states_close(got[0], ref[0], **tol)
    names = ("obs", "rewards", "game_over", "info")
    tp.assert_tree_close(dict(zip(names, got[1:])), dict(zip(names, ref[1:])), path="out", **tol)
    assert got[0].laserscan_history.numpy().tobytes() == np.asarray(
        ref[0].laserscan_history).tobytes()
    # the batch exercises what the step decides
    old = leaves
    new = tp.jax_leaves(ref[0])
    assert (new["in_collision"] & ~old["in_collision"]).any()           # walls
    assert (new["laserscan_count"] == 1).any() and (new["laserscan_count"] > 1).any()
    if isinstance(laser, tuple):
        assert (new["laserscan_count"][:, 1] == old["laserscan_count"][:, 1]).all()
    assert ("laserscan_exactness_overflow" in got[4]) == (route == "fast")
    # the batched step and env_reset take the same map arguments
    b = tbatch.batched_env_step(tp.convert.state_from_numpy(leaves, device=tp.DEVICE), None,
                                tcfg, None, (NONCOOP, STATIC), sensors, OBS, static,
                                cells if with_cells else None)
    tp.assert_states_close(b[0], ref[0], **tol)
    rj = jax.jit(jax.vmap(lambda s: j_env_reset(s, jcfg, sensors, OBS, jnp.asarray(static),
                                                jcells)))(tp.jax_state(leaves))
    rt = t_env_reset(tp.convert.state_from_numpy(leaves, device=tp.DEVICE), tcfg, sensors, OBS,
                     static, cells if with_cells else None)
    tp.assert_tree_close(rt[1], rj[1], path="reset_obs", **tol)


def test_autoreset_laser_loop_matches_jax():
    E, A, N, T = 4, 4, 4, 110
    jcfg, tcfg = _cfgs("float64", done_mode="evaluate", **FAST)
    # the benchmark's empty map, and radii that fit the 12-sample window, so
    # the guard stays quiet (with the 002 map's cells every step trips it:
    # a beam through the obstacle crosses more than Cs cell sources)
    static, cells = _maps(with_map=False)
    pool = trc.scenario_pool(N, A, seed=2, side_length=4.0)
    pool[..., 5] = np.minimum(pool[..., 5], 0.3)
    policy_id = np.full(A, NONCOOP, np.int32)
    sensors = ("other_agents_states", "laserscan")
    jstep = jax.jit(jax.vmap(jauto.make_autoreset_step(
        jcfg, jnp.asarray(pool), policy_id, (NONCOOP,), sensors, OBS,
        static_map=jnp.asarray(static), static_cells=jnp.asarray(cells), return_info=True)))
    jst = jax.vmap(lambda c: jauto.state_from_case(jcfg, c, policy_id))(
        jnp.asarray(pool[np.arange(E) % N]))
    jc = jnp.arange(E, dtype=jnp.int32)
    tstep = tauto.make_autoreset_step(tcfg, pool, policy_id, (NONCOOP,), sensors, OBS,
                                      device=tp.DEVICE, static_map=static, static_cells=cells,
                                      return_info=True)
    tst = tauto.state_from_case(tcfg, pool[np.arange(E) % N], policy_id, device=tp.DEVICE)
    tc = torch.arange(E, dtype=torch.int32)
    tol = dict(rtol=0, atol=1e-9)
    names = ("counter", "obs", "rewards", "game_over", "info")
    guard = []
    for t in range(T):
        jst, jc, jobs, jrew, jgo, jinfo = jstep(jst, jc)
        tst, tc, tobs, trew, tgo, tinfo = tstep(tst, tc)
        tp.assert_tree_close(dict(zip(names, (tc, tobs, trew, tgo, tinfo))),
                             dict(zip(names, (jc, jobs, jrew, jgo, jinfo))),
                             path=f"step{t}", **tol)
        tp.assert_states_close(tst, jst, **tol)
        guard.append(np.asarray(jinfo["laserscan_exactness_overflow"]))
    resets = np.asarray(jc) - np.arange(E)
    assert resets.min() >= 2, resets
    assert (np.asarray(jobs["laserscan"]) < 6.0).any()
    assert not np.any(guard)


def test_fast_laser_needs_return_info():
    _, tcfg = _cfgs("float32", **FAST)
    static, cells = _maps(False)
    pool = trc.scenario_pool(2, 3, seed=0)
    pid = np.full(3, NONCOOP, np.int32)
    with pytest.raises(ValueError, match="return_info"):
        tauto.make_autoreset_step(tcfg, pool, pid, sensors=("other_agents_states", "laserscan"), device=tp.DEVICE,
                                  static_map=static, static_cells=cells)
    step = tauto.make_autoreset_step(tcfg, pool, pid, sensors=("other_agents_states", "laserscan"),
                                     device=tp.DEVICE, static_map=static, static_cells=cells,
                                     return_info=True)
    st = tauto.state_from_case(tcfg, pool, pid, device=tp.DEVICE)
    out = step(st, torch.arange(2, dtype=torch.int32))
    assert len(out) == 6 and out[5]["laserscan_exactness_overflow"].shape == (2,)
    # the full pass needs no guard, so it needs no info either
    _, full = _cfgs("float32")
    assert len(tauto.make_autoreset_step(full, pool, pid, sensors=("other_agents_states", "laserscan"),
                                         device=tp.DEVICE, static_map=static,
                                         static_cells=cells)(st, out[1])) == 5


def test_float32_laser_serving_stays_finite():
    _, tcfg = _cfgs("float32", **FAST)
    static, cells = _maps()
    server = TServer(tcfg, trc.scenario_pool(8, 4, seed=3, side_length=4.0),
                     np.full(4, NONCOOP, np.int32), num_envs=8, steps_per_dispatch=25,
                     sensors=("other_agents_states", "laserscan"),
                     states_in_obs=OBS, collect=("laserscan",), static_map=static,
                     static_cells=cells, device=tp.DEVICE)
    tripped = False
    for _ in range(4):
        out = server.dispatch()
        assert torch.isfinite(out["laserscan"]).all()
        assert torch.isfinite(out["mean_reward"]).all()
        assert out["exactness_overflow"].shape == (25,)
        tripped |= bool(out["exactness_overflow"].any())
    for name, leaf in server.states().items():
        if leaf.is_floating_point():
            assert torch.isfinite(leaf).all(), name
    assert server.episodes_completed() > 8
    assert server.exactness_overflow() == tripped
    assert (out["laserscan"] < 6.0).any()
