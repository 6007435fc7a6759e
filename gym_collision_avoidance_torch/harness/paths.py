"""The serving paths that the repo's benchmarks name, as the port runs them.

``chip_smoke.py``, ``scripts/profile_torch_serving.py`` and
``scripts/compare_devices.py`` build every configuration here:

* ``main``: ``bench.py``'s serving loop, 4 NonCoop agents on a 64-case
  ``scenario_pool``, float32, evaluate mode, 16384 envs;
* ``ga3c4``: ``scripts/bench_all.py:bench_ga3c4_serving``, 4 GA3C-CADRL
  agents with the iros18 weights, 19 observed slots sorted closest last,
  4096 envs;
* ``orca4``: its ``bench_orca4``, 4 RVO agents, 16384 envs;
* ``cadrl4``: its ``bench_cadrl4``, 4 SA-CADRL agents on
  ``circle_scenario(4, radius=3.0, agent_radius=0.5)`` as a one-case pool,
  the ``no_constr`` value net, float32, 4096 envs;
* ``drl2``: ``scripts/eval_drl_long.py``'s world, a DRL-Long agent with the
  shipped ``drl_long_2agent_rvo_tpu`` net against an RVO agent, evaluate
  mode, the empty 16 x 16 m map, 512 beams on the full pass, a 64-case
  pool, 4096 envs;
* ``laser_full`` / ``laser_fast``: ``bench_ga3c20_laser``, 20 GA3C-CADRL
  agents on ``circle_scenario(20, radius=8.0, agent_radius=0.3)``, 512
  beams, the empty 20 x 20 m map, 256 envs, without and with its fast
  route (wedge culling to 9 discs, 12-sample windows, 4 beam slots).

Three training paths, each a published recipe of ``scripts/train_ppo.py``,
run by the port's PPO trainer (:func:`training_path`):

* ``train_ga3c4``: stage 3 of ``scripts/train_curriculum.sh``, GA3C-CADRL
  self-play with 4 agents, 256 envs, horizon 64, shaping 0.1, warm-started
  from ``ppo_selfplay_4agent_curr``;
* ``train_drl2``: ``RESULTS.md``'s DRL-Long recipe, the CNN against an RVO
  agent, 1024 envs, horizon 64, lr 1e-3, no entropy bonus, shaping 0.15, 512
  beams in an agents-only world;
* ``train_mlp2``: ``README.md``'s example, the MLP (hidden 256) against an RVO
  agent, 1024 envs, horizon 64.

Each takes the script's default pool: 256 cases of side 4 m, seed 0.

Example::

    path = serving_path("cadrl4", device="cuda")
    server = path.server(steps_per_dispatch=64)
    server.dispatch()

    train = training_path("train_drl2")
    trainer = train.trainer(device="cuda")
    carry = train.init(trainer)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.device import params_to_device
from gym_collision_avoidance_torch.env import autoreset
from gym_collision_avoidance_torch.env.step import env_step
from gym_collision_avoidance_torch.harness.serving import AutoresetServer
from gym_collision_avoidance_torch.maps import grid
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.policies import registry
from gym_collision_avoidance_torch.scenarios import presets, random_cases
from gym_collision_avoidance_torch.train.ppo import PPOConfig, PPOTrainer

PATHS = ("main", "ga3c4", "orca4", "cadrl4", "drl2", "laser_full", "laser_fast")
TRAIN_PATHS = ("train_ga3c4", "train_drl2", "train_mlp2")
# The evaluation campaign's 4-agent cells (harness/experiments.py:run_suite_cell:
# the 500 frozen cases, float32, EnvConfig.evaluate): name -> policy.
SUITE_PATHS = {"suite_cadrl4": "CADRL", "suite_rvo4": "RVO", "suite_ga3c4": "GA3C-CADRL-10"}
SUITE_AGENTS, SUITE_CASES = 4, 500

LASER_SENSORS = ("other_agents_states", "laserscan")
LASER_OBS = ("num_other_agents", "dist_to_goal", "heading_ego_frame", "pref_speed", "radius",
             "other_agents_states", "laserscan")
# scripts/eval_drl_long.py's observation keys
DRL2_OBS = ("dist_to_goal", "heading_ego_frame", "pref_speed", "radius", "laserscan")


@dataclasses.dataclass
class ServingPath:
    """What ``AutoresetServer``, ``make_autoreset_step`` and ``env_step``
    take for one path, besides the states."""

    name: str
    cfg: EnvConfig
    pool: np.ndarray                      # [N, A, 6]
    policy_id: np.ndarray                 # [A]
    params: Optional[dict]
    num_envs: int
    sensors: Tuple[str, ...] = ("other_agents_states",)
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS
    static_map: Optional[torch.Tensor] = None
    static_cells: Optional[torch.Tensor] = None

    @property
    def active(self) -> Tuple[int, ...]:
        return tuple(sorted({int(p) for p in self.policy_id}))

    @property
    def world(self) -> dict:
        """The sensor and map keywords of ``AutoresetServer`` and
        ``make_autoreset_step``."""
        return dict(sensors=self.sensors, states_in_obs=self.states_in_obs,
                    static_map=self.static_map, static_cells=self.static_cells)

    def to(self, device) -> "ServingPath":
        """A copy whose weights and map live on ``device``."""
        def move(x):
            return None if x is None else x.to(device)
        return dataclasses.replace(self, params=params_to_device(self.params, device),
                                   static_map=move(self.static_map),
                                   static_cells=move(self.static_cells))

    def server(self, num_envs: Optional[int] = None, **kw) -> AutoresetServer:
        return AutoresetServer(self.cfg, self.pool, self.policy_id,
                               num_envs=num_envs or self.num_envs, params=self.params,
                               **self.world, **kw)

    def step(self, state):
        """One ``env_step`` of ``state`` on its device; weights and map must
        be there too (:meth:`to`)."""
        return env_step(state, None, self.cfg, self.params, self.active, self.sensors,
                        self.states_in_obs, self.static_map, self.static_cells)


def laser_config(fast: bool, dtype: str = "float32", **overrides) -> EnvConfig:
    """``bench_ga3c20_laser``'s EnvConfig; ``fast=False`` drops its wedge,
    window and beam slots (the full pass)."""
    kw = dict(dtype=dtype, max_num_other_agents_observed=19,
              agent_sorting_method="closest_last", use_static_map=True,
              map_x_width=20.0, map_y_width=20.0, laserscan_length=512)
    if fast:
        kw.update(laserscan_num_candidate_discs=9, laserscan_entry_window=12,
                  laserscan_beam_slots=4)
    kw.update(overrides)
    return EnvConfig(**kw)


def map_inputs(cfg: EnvConfig, device, map_name: Optional[str] = None, pad: int = 0):
    """The ``[H, W]`` static map (empty, or one of the package's world maps)
    and its occupied-cell list with ``pad`` rows of -1, on ``device``."""
    static = grid.load_static_map(cfg, None if map_name is None else grid.world_map_path(map_name))
    cells = grid.occupied_cell_list(static, int(static.sum()) + pad)
    return torch.as_tensor(static, device=device), torch.as_tensor(cells, device=device)


def _one_case(scenario) -> np.ndarray:
    return np.concatenate([scenario.pos, scenario.goal, scenario.pref_speed[:, None],
                           scenario.radius[:, None]], -1)[None]


def serving_path(name: str, device="cuda") -> ServingPath:
    """The path ``name`` (one of :data:`PATHS`) with its weights and map on
    ``device``."""
    from gym_collision_avoidance_torch.models import cadrl, drl_long, ga3c_cadrl

    if name not in PATHS:
        raise ValueError(f"unknown path {name!r}; one of {PATHS}")
    if name in ("main", "orca4", "ga3c4"):
        pool4 = random_cases.scenario_pool(64, 4, seed=0, side_length=4.0)
    if name in ("main", "orca4"):
        policy = registry.NONCOOP if name == "main" else registry.RVO
        return ServingPath(name, EnvConfig(dtype="float32", done_mode="evaluate"), pool4,
                           np.full(4, policy, np.int32), None, 16384)
    if name == "ga3c4":
        cfg = EnvConfig(dtype="float32", done_mode="evaluate", max_num_other_agents_observed=19,
                        agent_sorting_method="closest_last")
        return ServingPath(name, cfg, pool4, np.full(4, registry.GA3C_CADRL, np.int32),
                           {"ga3c_cadrl": ga3c_cadrl.load_params(device=device)}, 4096)
    if name == "cadrl4":
        sc = presets.circle_scenario(4, radius=3.0, agent_radius=0.5, policy="CADRL")
        return ServingPath(name, EnvConfig(dtype="float32"), _one_case(sc),
                           np.full(4, registry.CADRL, np.int32),
                           {"cadrl": cadrl.load_params("no_constr", device=device)}, 4096)
    if name == "drl2":
        cfg = EnvConfig(dtype="float32", done_mode="evaluate", use_static_map=True)
        static, cells = map_inputs(cfg, device)
        return ServingPath(name, cfg, random_cases.scenario_pool(64, 2, seed=0, side_length=4.0),
                           np.array([registry.DRL_LONG, registry.RVO], np.int32),
                           {"drl_long": drl_long.load_params(device=device)}, 4096,
                           LASER_SENSORS, DRL2_OBS, static, cells)
    cfg = laser_config(name == "laser_fast")
    static, cells = map_inputs(cfg, device)
    sc = presets.circle_scenario(20, radius=8.0, agent_radius=0.3)
    return ServingPath(name, cfg, _one_case(sc), np.full(20, registry.GA3C_CADRL, np.int32),
                       {"ga3c_cadrl": ga3c_cadrl.load_params(device=device)}, 256,
                       LASER_SENSORS, LASER_OBS, static, cells)


@functools.lru_cache(maxsize=None)
def one_case_per_env(num_envs: int, num_agents: int) -> np.ndarray:
    """``scenario_pool(num_envs, num_agents)``: a pool with one case per env
    (cached: a 16384-case pool takes tens of seconds to draw)."""
    return random_cases.scenario_pool(num_envs, num_agents, seed=0, side_length=4.0)


def mid_episode_states(path: ServingPath, num_envs: int, steps: int, device="cuda"):
    """States ``steps`` auto-reset steps into ``path``'s loop on ``device``,
    started from :func:`one_case_per_env` so that the envs follow distinct
    trajectories, and the count of distinct pool cases the envs are on at
    the end.  ``path``'s weights and map must be on ``device``."""
    pool = one_case_per_env(num_envs, len(path.policy_id))
    step = autoreset.make_autoreset_step(path.cfg, pool, path.policy_id, path.active,
                                         params=path.params, device=device, **path.world)
    state = autoreset.state_from_case(path.cfg, pool, path.policy_id, device=device)
    counter = torch.arange(num_envs, dtype=torch.int32, device=device)
    for _ in range(steps):
        state, counter = step(state, counter)[:2]
    return state, int(torch.unique(counter % len(pool)).numel())


@functools.lru_cache(maxsize=None)
def _train_pool(num_agents: int) -> np.ndarray:
    """``scripts/train_ppo.py``'s default pool: 256 cases, side 4 m, seed 0."""
    return random_cases.scenario_pool(256, num_agents, seed=0, side_length=4.0)


@dataclasses.dataclass
class TrainingPath:
    """A PPO recipe: its config, pool and warm-start checkpoint."""

    name: str
    ppo: PPOConfig
    pool: np.ndarray
    init_params: Optional[str] = None     # a models.ga3c_cadrl checkpoint name

    def resized(self, num_envs: int, horizon: int) -> "TrainingPath":
        """The same recipe at another env count and horizon."""
        return dataclasses.replace(self, ppo=dataclasses.replace(
            self.ppo, num_envs=num_envs, horizon=horizon))

    def trainer(self, device="cuda") -> PPOTrainer:
        return PPOTrainer(self.ppo, pool=self.pool, device=device)

    def init(self, trainer):
        """``trainer.init_fn``'s carry for the recipe's seed, with the
        warm-start net in place of the fresh one where the recipe has one."""
        carry = list(trainer.init_fn(self.ppo.seed))
        if self.init_params is not None:
            from gym_collision_avoidance_torch import convert
            from gym_collision_avoidance_torch.models import ga3c_cadrl

            with np.load(ga3c_cadrl.CHECKPOINTS[self.init_params]) as z:
                arrays = {k: z[k] for k in z.files}
            carry[0] = convert.ppo_params_from_numpy(self.ppo.policy_arch, arrays,
                                                     trainer.device)
        return carry


def training_path(name: str) -> TrainingPath:
    """The training path ``name`` (one of :data:`TRAIN_PATHS`)."""
    if name == "train_ga3c4":
        # scripts/train_curriculum.sh:25-30, stage 3
        ppo = PPOConfig(num_envs=256, horizon=64, num_agents=4, policy_arch="ga3c",
                        self_play=True, shaping_coef=0.1)
        return TrainingPath(name, ppo, _train_pool(4), "ppo_selfplay_4agent_curr")
    if name == "train_drl2":
        # RESULTS.md's DRL-Long recipe (drl_long_2agent_rvo_tpu)
        ppo = PPOConfig(num_envs=1024, horizon=64, num_agents=2, policy_arch="drl_long",
                        traffic_policy=registry.RVO, lr=1e-3, entropy_coef=0.0,
                        shaping_coef=0.15)
        return TrainingPath(name, ppo, _train_pool(2))
    if name == "train_mlp2":
        # README.md's train_ppo.py example
        ppo = PPOConfig(num_envs=1024, horizon=64, num_agents=2, traffic_policy=registry.RVO)
        return TrainingPath(name, ppo, _train_pool(2))
    raise ValueError(f"unknown training path {name!r}; one of {TRAIN_PATHS}")
