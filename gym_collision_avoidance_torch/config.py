"""Static environment configuration.

A copy of :mod:`gym_collision_avoidance_tpu.config` (same fields, defaults
and preset constructors): importing the JAX package's module would run that
package's ``__init__``, which imports jax.  ``tests/test_torch_config.py``
holds the two dataclasses equal field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Agent-sorting methods for the other-agents sensor
# (reference: envs/config.py:173-175).
SORT_CLOSEST_FIRST = "closest_first"
SORT_CLOSEST_LAST = "closest_last"
SORT_TIME_TO_IMPACT = "time_to_impact"

# Episode-termination ("game over") modes
# (reference: envs/collision_avoidance_env.py:538-551).
DONE_MODE_EVALUATE = "evaluate"        # all agents done
DONE_MODE_SINGLE_AGENT = "single"      # agent 0 done
DONE_MODE_LEARNING = "learning"        # all still-learning agents done


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """All static knobs of the simulation.

    Defaults mirror the reference base ``Config`` (``envs/config.py:29-86``).
    """

    # --- simulation (envs/config.py:44-47) ---
    dt: float = 0.2
    near_goal_threshold: float = 0.2
    max_time_ratio: float = 2.0

    # --- rewards (envs/config.py:29-39) ---
    reward_at_goal: float = 1.0
    reward_collision_with_agent: float = -0.25
    reward_collision_with_wall: float = -0.25
    reward_getting_close: float = -0.1
    reward_time_step: float = 0.0
    reward_wiggly_behavior: float = 0.0
    wiggly_behavior_threshold: float = np.inf
    collision_dist: float = 0.0
    getting_close_range: float = 0.2

    # --- sensing (envs/config.py:76-80) ---
    sensing_horizon: float = np.inf
    max_num_other_agents_observed: int = 3
    agent_sorting_method: str = SORT_CLOSEST_FIRST
    laserscan_length: int = 512
    laserscan_num_past: int = 3
    laserscan_num_candidate_discs: int | None = None
    laserscan_entry_window: int | None = None
    laserscan_beam_slots: int | None = None

    # --- CADRL value-net social norm (CADRLPolicy.py:22-23) ---
    cadrl_passing_side: str = "none"
    cadrl_mode: str = "no_constr"

    # --- RVO / ORCA (envs/config.py:84-86) ---
    rvo_time_horizon: float = 5.0
    rvo_collab_coeff: float = 0.5
    rvo_anti_collab_t: float = 1.0

    # --- termination / mode ---
    done_mode: str = DONE_MODE_EVALUATE

    # --- maps / laserscan sensors ---
    use_static_map: bool = False
    map_x_width: float = 16.0           # envs/collision_avoidance_env.py:389-391
    map_y_width: float = 16.0
    map_grid_cell_size: float = 0.1

    # --- numerics ---
    dtype: str = "float32"
    # The reference buffers every action through a float32 array before
    # integrating dynamics (envs/collision_avoidance_env.py:304-306).
    cast_actions_to_f32: bool = True
    # Bitwise-parity mode: atan2 and the dynamics in host numpy, as the
    # reference computes them (core/maths.py, core/dynamics.py); a host round
    # trip each step, for validation, not speed.
    strict_parity: bool = False

    # env-wide action limits applied to learning policies
    # (envs/collision_avoidance_env.py:88-91)
    max_speed: float = 1.0
    max_heading_change: float = np.pi / 3

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    @staticmethod
    def evaluate(**overrides) -> "EnvConfig":
        """Mirror of ``EvaluateConfig`` (envs/config.py:193-200)."""
        base = dict(dt=0.1, max_time_ratio=8.0, done_mode=DONE_MODE_EVALUATE)
        base.update(overrides)
        return EnvConfig(**base)

    @staticmethod
    def train(**overrides) -> "EnvConfig":
        """Mirror of the base train-mode ``Config`` (envs/config.py:24-27)."""
        base = dict(dt=0.2, max_time_ratio=2.0, done_mode=DONE_MODE_LEARNING)
        base.update(overrides)
        return EnvConfig(**base)

    def replace(self, **overrides) -> "EnvConfig":
        return dataclasses.replace(self, **overrides)
