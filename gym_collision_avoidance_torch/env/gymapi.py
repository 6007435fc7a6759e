"""Gymnasium-compatible front end (port of
:mod:`gym_collision_avoidance_tpu.env.gymapi`).

A host-side API mirroring the reference's ``CollisionAvoidanceEnv`` surface
(``gym.make``-style class with ``step(actions) -> (obs, rewards, game_over,
truncated, info)``, ``set_agents``-like scenario binding, plot-dir plumbing,
envs/collision_avoidance_env.py:33-646) over one env of the batched core: the
state is ``[1, A]`` on ``device`` and the host observations drop the env
axis.  Heavy users should drive :func:`env.step.env_step` or the batched
harness directly; this class exists for API familiarity and single-env
interactive use.

gymnasium is optional: without it the class subclasses ``object`` and has no
``action_space``/``observation_space``, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

try:
    import gymnasium as gym

    _BASE = gym.Env
except ImportError:
    gym = None
    _BASE = object

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.device import params_to_device, resolve_device
from gym_collision_avoidance_torch.env.step import env_reset, env_step
from gym_collision_avoidance_torch.harness import visualize
from gym_collision_avoidance_torch.maps import grid as map_grid
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.scenarios import presets

ENV_ID = "CollisionAvoidanceTorch-v0"


def _host(x: torch.Tensor) -> np.ndarray:
    """The one env of a ``[1, ...]`` tensor, as numpy."""
    return x[0].cpu().numpy()


class CollisionAvoidanceEnv(_BASE):
    """Single-env, host-API wrapper over the batched core.

    ``device=None`` means CUDA; ``params`` and a ``static_map`` array are
    moved there once.
    """

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(
        self,
        cfg: Optional[EnvConfig] = None,
        scenario: Optional[presets.Scenario] = None,
        scenario_fn=None,
        params=None,
        sensors: Tuple[str, ...] = ("other_agents_states",),
        states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
        static_map=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or EnvConfig()
        self._scenario = scenario
        self._scenario_fn = scenario_fn
        self.params = params_to_device(params, self.device)
        self.sensors = tuple(sensors)
        self.states_in_obs = tuple(states_in_obs)
        self._static_map_filename = None
        self._loaded_map_filename = None
        self.static_map = self.static_cells = None
        if static_map is not None:
            self._set_map_array(np.asarray(static_map, bool))
        self.state = None
        self._active = None
        self.episode_step_number = 0
        self.plot_save_dir = None
        self._history = []

        if gym is not None:
            self.action_space = gym.spaces.Box(
                np.array([0.0, -np.pi / 3], np.float32),
                np.array([self.cfg.max_speed, np.pi / 3], np.float32),
            )
            # per-key Box spaces mirroring STATE_INFO_DICT sizes/bounds
            # (collision_avoidance_env.py:120-139)
            K = self.cfg.max_num_other_agents_observed
            shapes = {
                "is_learning": ((1,), 0.0, 1.0),
                "num_other_agents": ((1,), 0, np.inf),
                "dist_to_goal": ((1,), -np.inf, np.inf),
                "heading_ego_frame": ((1,), -np.pi, np.pi),
                "pref_speed": ((1,), 0, np.inf),
                "radius": ((1,), 0, np.inf),
                "other_agent_states": ((7,), -np.inf, np.inf),
                "other_agents_states": ((K, 7), -np.inf, np.inf),
                "laserscan": (
                    (self.cfg.laserscan_num_past, self.cfg.laserscan_length),
                    0.0, 6.0,
                ),
            }
            self.observation_space = gym.spaces.Dict(
                {
                    key: gym.spaces.Box(lo, hi, shape=shape, dtype=np.float32)
                    for key, (shape, lo, hi) in shapes.items()
                    if key in self.states_in_obs
                }
            )

    # -- reference-API surface ------------------------------------------

    def set_scenario(self, scenario: presets.Scenario):
        """Analog of ``env.set_agents(...)``: fix the initial configuration
        used on every reset."""
        self._scenario = scenario

    def set_testcase_fn(self, fn):
        """Analog of ``env.set_testcase``: a callable returning a Scenario,
        invoked on each reset."""
        self._scenario_fn = fn

    def set_static_map(self, map_filename):
        """Analog of the reference's ``set_static_map``
        (collision_avoidance_env.py:369-392): a binary-PNG path (or a list
        of candidate paths randomly chosen between each episode).  The map
        is rasterized at the config's grid dims on the next reset, and its
        ``static_map`` and ``static_cells`` are moved to the device once per
        file."""
        self._static_map_filename = map_filename

    def set_plot_save_dir(self, d):
        os.makedirs(d, exist_ok=True)
        self.plot_save_dir = d

    def reset(self, *, seed=None, options=None):
        if self._scenario is None and self._scenario_fn is None:
            raise ValueError("call set_scenario()/set_testcase_fn() first")
        sc = self._scenario_fn() if self._scenario_fn is not None else self._scenario
        self._sc = sc
        if self._static_map_filename is not None:
            fname = self._static_map_filename
            if isinstance(fname, (list, tuple)):
                # reference picks a random candidate each episode
                # (collision_avoidance_env.py:384-387)
                fname = np.random.choice(list(fname))
            if fname != self._loaded_map_filename:
                self._set_map_array(map_grid.load_static_map(self.cfg, fname))
                self._loaded_map_filename = fname
        self._active = sc.active_policies
        state = sc.to_state(self.cfg, device=self.device)
        self.state, obs = env_reset(state, self.cfg, self.sensors, self.states_in_obs,
                                    self.static_map, self.static_cells)
        self.episode_step_number = 0
        self._history = [_host(self.state.pos)]
        return self._to_host_obs(obs), {}

    def step(self, actions=None, dt=None):
        """``actions``: None (all-internal policies), or a dict
        {agent_index: action} / [A, 2] array for external agents
        (collision_avoidance_env.py:156-234).  ``dt`` overrides the
        config's step length for this call (collision_avoidance_env.py:178-181)."""
        cfg = self.cfg if dt is None else self.cfg.replace(dt=float(dt))
        ext = None
        if actions is not None:
            if isinstance(actions, dict):
                ext = np.zeros((self.state.pos.shape[1], 2), np.float64)
                for i, a in actions.items():
                    ext[i, : np.size(a)] = a
            else:
                ext = np.asarray(actions)
            ext = ext[None]
        self.state, obs, rewards, game_over, info = env_step(
            self.state, ext, cfg, self.params, self._active,
            self.sensors, self.states_in_obs, self.static_map, self.static_cells,
        )
        self.episode_step_number += 1
        self._history.append(_host(self.state.pos))
        info = {k: _host(v) for k, v in info.items()}
        return (
            self._to_host_obs(obs),
            _host(rewards),
            bool(game_over[0]),
            False,
            info,
        )

    def plot_episode(self, save_path=None, **kwargs):
        positions = np.stack(self._history)
        if save_path is None and self.plot_save_dir is not None:
            save_path = os.path.join(
                self.plot_save_dir,
                f"{self.episode_step_number:03d}_{positions.shape[1]}agents.png",
            )
        return visualize.plot_episode(
            positions,
            _host(self.state.radius),
            goals=_host(self.state.goal),
            dt=self.cfg.dt,
            save_path=save_path,
            # collision episodes get a copy under <dir>/collisions/
            # (envs/visualize.py:34-35,148-149)
            in_collision=_host(self.state.in_collision),
            **kwargs,
        )

    # -- helpers ---------------------------------------------------------

    def _set_map_array(self, static_map: np.ndarray):
        """The map and its occupied-cell list, on the device."""
        self.static_map = torch.as_tensor(static_map, device=self.device)
        self.static_cells = torch.as_tensor(map_grid.occupied_cell_list(static_map),
                                            device=self.device)

    def _to_host_obs(self, obs) -> Dict[int, Dict[str, np.ndarray]]:
        """Device dict of ``[1, A, ...]`` tensors -> the reference's
        per-agent nested dict {agent_index: {key: np.array}}."""
        host = {k: _host(v) for k, v in obs.items()}
        A = self.state.pos.shape[1]
        return {i: {k: v[i] for k, v in host.items()} for i in range(A)}

    @property
    def agents(self):
        """Lightweight agent views for stats code expecting `.t`,
        `.in_collision`, etc."""
        s = {k: _host(getattr(self.state, k)) for k in (
            "t", "in_collision", "is_at_goal", "ran_out_of_time", "pos", "goal", "radius")}

        class _View:
            def __init__(self, i):
                self.t = float(s["t"][i])
                self.in_collision = bool(s["in_collision"][i])
                self.is_at_goal = bool(s["is_at_goal"][i])
                self.ran_out_of_time = bool(s["ran_out_of_time"][i])
                self.pos_global_frame = s["pos"][i]
                self.goal_global_frame = s["goal"][i]
                self.radius = float(s["radius"][i])

        return [_View(i) for i in range(self.state.pos.shape[1])]


def register_gym_env(env_id: str = ENV_ID):
    """Register with gymnasium (the reference registers
    CollisionAvoidance-v0 via gym's registry,
    gym_collision_avoidance/__init__.py:2-9; that id and
    CollisionAvoidanceTpu-v0 belong to the JAX package)."""
    if gym is None:
        raise ImportError("gymnasium not available")
    from gymnasium.envs.registration import register, registry

    if env_id in registry:  # idempotent, like repeated package imports
        return env_id
    # The multiagent obs (dict keyed by agent index) predates gymnasium's
    # passive checker conventions, exactly like the reference's env.
    register(id=env_id, entry_point=CollisionAvoidanceEnv,
             disable_env_checker=True)
    return env_id
