"""The port's gym front end (``env.gymapi.CollisionAvoidanceEnv``) on the CPU:
the JAX package's ``tests/test_api_wrappers.py`` cases run on the port, the
``CollisionAvoidanceTorch-v0`` registration, and whole episodes against the
JAX package's env.

Episodes against JAX, float64: NonCoop on ``two_agents_swap`` and
GA3C-CADRL-10 on the 4-agent circle case.  Host observations, rewards and the
agents' positions agree to 1e-9 at every step (XLA's and torch's
atan2/sin/cos differ by ulps), game over comes at the same step.  The laser
env on map 002 (the port's sparse route through the static-cell list, JAX's
dense pass) gives equal laser ranges.
"""

import os

import numpy as np
import pytest

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch.env import gymapi as tgym
from gym_collision_avoidance_torch.harness import registry as treg
from gym_collision_avoidance_torch.maps import grid as tgrid
from gym_collision_avoidance_torch.obs.wrappers import ObsLayout
from gym_collision_avoidance_torch.policies import registry as TP
from gym_collision_avoidance_torch.scenarios import presets as tpresets
from gym_collision_avoidance_torch.scenarios import suites as tsuites
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu.env import gymapi as jgym
from gym_collision_avoidance_tpu.harness import registry as jreg
from gym_collision_avoidance_tpu.scenarios import presets as jpresets

CPU = tp.DEVICE
TOL = dict(rtol=1e-9, atol=1e-9)


def _env(**kw):
    return tgym.CollisionAvoidanceEnv(device=CPU, **kw)


# -- the JAX package's tests/test_api_wrappers.py cases, on the port --------


def test_gym_api_roundtrip():
    env = _env(cfg=TCfg.evaluate(dtype="float32"))
    env.set_scenario(tpresets.two_agents_swap())
    obs, info = env.reset()
    assert set(obs) == {0, 1}
    assert "dist_to_goal" in obs[0]
    terminated = False
    steps = 0
    while not terminated and steps < 200:
        obs, rew, terminated, truncated, info = env.step(None)
        steps += 1
    assert terminated
    assert rew.shape == (2,)
    views = env.agents
    assert views[0].in_collision or views[0].is_at_goal


def test_gym_api_external_actions_dict():
    env = _env(cfg=TCfg(dtype="float32"))
    sc = tpresets.two_agents_swap()
    sc.policy_id = np.array([TP.LEARNING, TP.NONCOOP])
    env.set_scenario(sc)
    env.reset()
    obs, rew, term, trunc, info = env.step({0: [1.0, 0.5]})
    assert info["which_agents_learning"][0]
    assert not info["which_agents_learning"][1]


def test_obs_layout_roundtrip():
    from gym_collision_avoidance_torch.env.step import env_reset

    cfg = TCfg.evaluate(dtype="float32")
    state = tpresets.circle_scenario(4, radius=3.0).to_state(cfg, device=CPU)
    state, obs = env_reset(state, cfg)
    layout = ObsLayout.from_obs(obs, list(obs))
    arr = layout.to_array(obs)
    assert arr.shape == (1, 4, layout.agent_size)
    flat = layout.to_flat(obs)
    assert flat.shape == (1, 4 * layout.agent_size)
    back = layout.to_dict(arr)
    for k in obs:
        np.testing.assert_array_equal(back[k].numpy(), obs[k].numpy())


def test_gym_registration():
    import gymnasium

    env_id = tgym.register_gym_env("CollisionAvoidanceTorch-test-v0")
    env = gymnasium.make(env_id, cfg=TCfg.evaluate(dtype="float32"), device=CPU)
    env.unwrapped.set_scenario(tpresets.two_agents_swap())
    obs, info = env.reset()
    assert 0 in obs


def test_default_gym_id_registered_at_import():
    """Importing the port registers ``CollisionAvoidanceTorch-v0``, and never
    the JAX package's ids."""
    import gymnasium
    from gymnasium.envs.registration import registry

    import gym_collision_avoidance_torch as pkg

    saved = registry.pop(tgym.ENV_ID, None)
    try:
        pkg._register_gym_id()
        env = gymnasium.make(tgym.ENV_ID, cfg=TCfg.evaluate(dtype="float32"), device=CPU)
        assert isinstance(env.unwrapped, tgym.CollisionAvoidanceEnv)
        env.unwrapped.set_scenario(tpresets.two_agents_swap())
        obs, _ = env.reset()
        assert 0 in obs
    finally:
        if saved is not None:
            registry[tgym.ENV_ID] = saved
    for env_id in ("CollisionAvoidance-v0", "CollisionAvoidanceTpu-v0"):
        spec = registry.get(env_id)
        assert spec is None or "torch" not in str(spec.entry_point), env_id


def test_set_static_map_loads_png_on_reset():
    """A PNG set before reset becomes the episode's static map (and its cell
    list), equal to the JAX env's; a list of candidates also works."""
    cfg = dict(dtype="float32", use_static_map=True, map_x_width=16.0, map_y_width=16.0)
    png = tgrid.world_map_path("002")
    env = _env(cfg=TCfg(**cfg))
    env.set_scenario(tpresets.two_agents_swap())
    env.set_static_map(png)
    env.reset()
    m = env.static_map.numpy()
    assert m.dtype == bool and m.any() and not m.all()
    np.testing.assert_array_equal(env.static_cells.numpy(), tgrid.occupied_cell_list(m))
    jenv = jgym.CollisionAvoidanceEnv(cfg=JCfg(**cfg))
    jenv.set_scenario(jpresets.two_agents_swap())
    jenv.set_static_map(png)
    jenv.reset()
    np.testing.assert_array_equal(m, np.asarray(jenv.static_map))
    env.set_static_map([png, png])
    env.reset()
    assert env.static_map.numpy().any()


# -- episodes against the JAX package's env ----------------------------------


def _run_both(tenv, jenv, max_steps, actions=None):
    """Step both envs to game over; every step's host obs, rewards and
    positions agree to ``TOL``.  Returns the step count."""
    tobs, _ = tenv.reset()
    jobs, _ = jenv.reset()
    for step in range(1, max_steps + 1):
        for i in jobs:
            for k in jobs[i]:
                np.testing.assert_allclose(tobs[i][k], np.asarray(jobs[i][k]), **TOL,
                                           err_msg=f"step {step} agent {i} {k}")
        tobs, trew, tdone, _, tinfo = tenv.step(actions)
        jobs, jrew, jdone, _, jinfo = jenv.step(actions)
        np.testing.assert_allclose(trew, np.asarray(jrew), **TOL)
        np.testing.assert_allclose(tenv.state.pos[0].numpy(), np.asarray(jenv.state.pos), **TOL)
        for k in jinfo:
            np.testing.assert_array_equal(tinfo[k], np.asarray(jinfo[k]), err_msg=k)
        assert tdone == jdone, step
        if tdone:
            return step
    raise AssertionError(f"no game over in {max_steps} steps")


def test_noncoop_swap_episode_matches_jax():
    tenv = _env(cfg=TCfg.evaluate(dtype="float64"), scenario=tpresets.two_agents_swap())
    jenv = jgym.CollisionAvoidanceEnv(cfg=JCfg.evaluate(dtype="float64"),
                                      scenario=jpresets.two_agents_swap())
    steps = _run_both(tenv, jenv, 200)
    views, jviews = tenv.agents, jenv.agents
    for v, w in zip(views, jviews):
        assert (v.in_collision, v.is_at_goal) == (w.in_collision, w.is_at_goal)
        assert v.t == pytest.approx(w.t, abs=1e-12)
    assert steps > 10


def test_ga3c_circle_episode_matches_jax(tmp_path):
    """The 4-agent small-suite circle case (``gen_circle_test_case``) under
    GA3C-CADRL-10, then ``plot_episode`` of the port's episode."""
    case = tsuites.gen_circle_test_case(4, 4.0)
    tcfg = treg.cfg_for_policy("GA3C-CADRL-10", TCfg.evaluate(dtype="float64"))
    jcfg = jreg.cfg_for_policy("GA3C-CADRL-10", JCfg.evaluate(dtype="float64"))
    tenv = _env(cfg=tcfg, scenario=tpresets.from_cadrl_case(case, policy="GA3C_CADRL"),
                params=treg.load_params("ga3c_cadrl", device=CPU))
    jenv = jgym.CollisionAvoidanceEnv(cfg=jcfg,
                                      scenario=jpresets.from_cadrl_case(case, policy="GA3C_CADRL"),
                                      params=jreg.load_params("ga3c_cadrl"))
    steps = _run_both(tenv, jenv, 300)
    assert all(v.is_at_goal for v in tenv.agents) and steps > 40
    tenv.set_plot_save_dir(str(tmp_path))
    path = tenv.plot_episode()
    assert path == os.path.join(str(tmp_path), f"{steps:03d}_4agents.png")
    assert os.path.getsize(path) > 0


def test_laser_env_on_map_002_matches_jax():
    """Five steps with the laserscan on map 002: the port's sparse route over
    the env's static-cell list against JAX's dense pass, ranges equal."""
    cfg = dict(dtype="float64", use_static_map=True, map_x_width=16.0, map_y_width=16.0,
               laserscan_length=64)
    sensors = ("other_agents_states", "laserscan")
    states_in_obs = ("dist_to_goal", "heading_ego_frame", "laserscan")
    png = tgrid.world_map_path("002")
    tenv = _env(cfg=TCfg(**cfg), scenario=tpresets.two_agents_swap(), sensors=sensors,
                states_in_obs=states_in_obs)
    jenv = jgym.CollisionAvoidanceEnv(cfg=JCfg(**cfg), scenario=jpresets.two_agents_swap(),
                                      sensors=sensors, states_in_obs=states_in_obs)
    tenv.set_static_map(png)
    jenv.set_static_map(png)
    tobs, _ = tenv.reset()
    jobs, _ = jenv.reset()
    for _ in range(5):
        for i in jobs:
            np.testing.assert_array_equal(tobs[i]["laserscan"], np.asarray(jobs[i]["laserscan"]))
        assert (tobs[0]["laserscan"] < 6.0).any()
        tobs, *_ = tenv.step()
        jobs, *_ = jenv.step()


def test_step_dt_override_and_no_gymnasium_spaces_needed():
    env = _env(cfg=TCfg.evaluate(dtype="float64"), scenario=tpresets.two_agents_swap())
    env.reset()
    env.step(dt=0.05)
    assert env.agents[0].t == pytest.approx(0.05)
    env.step()
    assert env.agents[0].t == pytest.approx(0.15)
    assert env.action_space.shape == (2,) and "dist_to_goal" in env.observation_space.spaces
