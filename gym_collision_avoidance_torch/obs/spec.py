"""Declarative observation assembly (port of
:mod:`gym_collision_avoidance_tpu.obs.spec`).

Each obs key maps to a function of the updated state; the observation is a
dict of ``[E, A, ...]`` tensors.  Default keys mirror ``Config.STATES_IN_OBS``
(``envs/config.py:179``).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from gym_collision_avoidance_torch.policies import registry as policies

DEFAULT_STATES_IN_OBS: Tuple[str, ...] = (
    "is_learning",
    "num_other_agents",
    "dist_to_goal",
    "heading_ego_frame",
    "pref_speed",
    "radius",
    "other_agents_states",
)

# STATES_IN_OBS minus STATES_NOT_USED_IN_POLICY (envs/config.py:183-184).
DEFAULT_STATES_NOT_USED_IN_POLICY: Tuple[str, ...] = ("is_learning",)


def _is_learning(state, cfg, sensed):
    mask = policies._isin(state.policy_id, policies.LEARNING_POLICIES)
    return mask.to(state.pos.dtype)[..., None]


_OBS_FNS: Dict[str, Callable] = {
    # key -> (state, cfg, sensed) -> [E, A, ...] tensor
    "is_learning": _is_learning,
    "num_other_agents": lambda s, c, sensed: s.num_other_agents_observed.to(s.pos.dtype)[..., None],
    "dist_to_goal": lambda s, c, sensed: s.dist_to_goal[..., None],
    "heading_ego_frame": lambda s, c, sensed: s.heading_ego_frame[..., None],
    "pref_speed": lambda s, c, sensed: s.pref_speed[..., None],
    "radius": lambda s, c, sensed: s.radius[..., None],
    "other_agent_states": lambda s, c, sensed: s.other_agent_states,
    "other_agents_states": lambda s, c, sensed: sensed["other_agents_states"],
    "laserscan": lambda s, c, sensed: sensed["laserscan"],
}

# Normalization statistics (envs/config.py:93-170 'mean'/'std' entries).
NORM_STATS = {
    "dist_to_goal": (0.0, 5.0),
    "radius": (0.5, 1.0),
    "heading_ego_frame": (0.0, 3.14),
    "pref_speed": (1.0, 1.0),
    "num_other_agents": (1.0, 1.0),
    "other_agent_states": (
        np.array([0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 1.0], np.float32),
        np.array([5.0, 5.0, 1.0, 1.0, 1.0, 5.0, 1.0], np.float32),
    ),
    "other_agents_states": (
        np.array([0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 1.0], np.float32),
        np.array([5.0, 5.0, 1.0, 1.0, 1.0, 5.0, 1.0], np.float32),
    ),
    "laserscan": (5.0, 5.0),
}


def build_observation(state, cfg, sensed, states_in_obs: Sequence[str] = DEFAULT_STATES_IN_OBS):
    """The dict observation of every agent: key -> ``[E, A, ...]``."""
    obs = {}
    for key in states_in_obs:
        obs[key] = _OBS_FNS[key](state, cfg, sensed)
    return obs


def flatten_policy_obs(obs, states_in_obs=DEFAULT_STATES_IN_OBS,
                       states_not_used=DEFAULT_STATES_NOT_USED_IN_POLICY):
    """The ``[E, A, total_len]`` vector a network policy consumes
    (GA3CCADRLPolicy.py:68-74)."""
    parts = []
    for key in states_in_obs:
        if key in states_not_used:
            continue
        arr = obs[key]
        parts.append(arr.reshape(arr.shape[0], arr.shape[1], -1))
    return torch.cat(parts, dim=-1)
