"""The port's auto-reset serving loop against the JAX package's
``make_autoreset_step`` under ``vmap`` and its ``AutoresetServer``: E = 8
envs of 4 NonCoop agents, an 8-case pool, float64, long enough for every env
to reset at least twice, with ``[A, 6]`` rows and with ``[A, 7]`` mixed
rows whose padding agents are invalid.

Episode counters, dones, game over and collisions are exact at every step;
float states and observations agree to atol 1e-9 (XLA's and torch's
atan2/sin/cos differ by ulps, which a trajectory carries forward).  A
200-step float32 run checks that the loop stays free of NaNs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch.env import autoreset as tauto
from gym_collision_avoidance_torch.harness.serving import AutoresetServer as TServer
from gym_collision_avoidance_torch.scenarios import random_cases as trc
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu.env import autoreset as jauto
from gym_collision_avoidance_tpu.harness.serving import AutoresetServer as JServer

E, A, N, T = 8, 4, 8, 120
NONCOOP = 2
TOL = dict(rtol=0, atol=1e-9)


def _pool(kind):
    if kind == "rows6":
        return trc.scenario_pool(N, A, seed=0, side_length=4.0)
    return trc.scenario_pool_mixed(N, (2, 3, 4), seed=1, side_length=4.0)


def _cfgs(dtype):
    # the configuration bench.py's serving loop runs
    kw = dict(dtype=dtype, done_mode="evaluate")
    return JCfg(**kw), TCfg(**kw)


@pytest.mark.parametrize("kind", ["rows6", "rows7_mixed"])
def test_autoreset_loop_matches_jax(kind):
    pool = _pool(kind)
    jcfg, tcfg = _cfgs("float64")
    policy_id = np.full(A, NONCOOP, np.int32)

    jstep = jax.jit(jax.vmap(jauto.make_autoreset_step(jcfg, jnp.asarray(pool), policy_id)))
    jst = jax.vmap(lambda c: jauto.state_from_case(jcfg, c, policy_id))(
        jnp.asarray(pool[np.arange(E) % N]))
    jc = jnp.arange(E, dtype=jnp.int32)

    tstep = tauto.make_autoreset_step(tcfg, pool, policy_id, device=tp.DEVICE,
                                      return_info=True)
    tst = tauto.state_from_case(tcfg, pool[np.arange(E) % N], policy_id, device=tp.DEVICE)
    tc = torch.arange(E, dtype=torch.int32)
    tp.assert_states_close(tst, jst, **TOL)

    names = ("counter", "obs", "rewards", "game_over")
    for t in range(T):
        jst, jc, jobs, jrew, jgo = jstep(jst, jc)
        tst, tc, tobs, trew, tgo, _info = tstep(tst, tc)
        tp.assert_tree_close(dict(zip(names, (tc, tobs, trew, tgo))),
                             dict(zip(names, (jc, jobs, jrew, jgo))),
                             path=f"step{t}", **TOL)
        tp.assert_states_close(tst, jst, **TOL)
    resets = np.asarray(jc) - np.arange(E)
    assert resets.min() >= 2, resets
    if kind == "rows7_mixed":
        assert not tst.valid.all() and tst.valid.any(dim=-1).all()


def test_server_matches_jax_server():
    pool = _pool("rows6")
    jcfg, tcfg = _cfgs("float64")
    policy_id = np.full(A, NONCOOP, np.int32)
    kw = dict(num_envs=E, steps_per_dispatch=40, collect=("other_agents_states",))
    jserver = JServer(jcfg, pool, policy_id, **kw)
    tserver = TServer(tcfg, pool, policy_id, device=tp.DEVICE, **kw)
    for _ in range(3):
        tp.assert_tree_close(tserver.dispatch(), jserver.dispatch(), path="out", **TOL)
    tp.assert_states_close(tserver.states(), jserver.states(), **TOL)
    assert tserver.episodes_completed() == jserver.episodes_completed() > 0


def test_float32_loop_stays_finite():
    _, tcfg = _cfgs("float32")
    server = TServer(tcfg, _pool("rows6"), np.full(A, NONCOOP, np.int32),
                     num_envs=64, steps_per_dispatch=50, device=tp.DEVICE)
    for _ in range(4):
        out = server.dispatch()
        assert torch.isfinite(out["mean_reward"]).all()
        assert torch.isfinite(out["obs_checksum"]).all()
    for name, leaf in server.states().items():
        if leaf.is_floating_point():
            assert torch.isfinite(leaf).all(), name
    assert server.episodes_completed() > 64
    assert server.throughput(reps=1, pipeline=1) > 0


@pytest.mark.parametrize("name", ["main", "ga3c4", "orca4", "cadrl4", "drl2", "laser_full",
                                  "laser_fast", "ga3c40", "sarl6"])
def test_serving_paths_run_on_the_cpu(name):
    """Each path of ``harness/paths.py`` (what ``chip_smoke.py`` and the
    profiling scripts drive) serves two steps of 2 envs on the CPU with
    finite rewards; the policy paths' mid-episode states start every env on
    its own pool case."""
    from gym_collision_avoidance_torch.harness import paths

    path = paths.serving_path(name, "cpu")
    assert name in paths.PATHS and path.num_envs >= 256
    out = path.server(num_envs=2, steps_per_dispatch=2, device="cpu").dispatch()
    assert out["mean_reward"].shape[0] == 2 and torch.isfinite(out["mean_reward"]).all()
    if not name.startswith("laser"):
        state, cases = paths.mid_episode_states(path, 3, 1, "cpu")
        assert state.pos.shape[:2] == (3, len(path.policy_id)) and cases == 3
