"""Batched-env stepping (port of :mod:`gym_collision_avoidance_tpu.env.batch`).

The JAX package needs this module to run policy networks once over the
flattened agent batch and vmap only the simulation.  The port's
:func:`env.step.env_step` is batched already, so this is a thin alias kept
for the module map.
"""

from __future__ import annotations

from typing import Tuple

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.env.step import env_step
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.policies import registry as policies


def batched_env_step(
    states,
    ext_actions,
    cfg: EnvConfig,
    params=None,
    active_policies: Tuple[int, ...] = (policies.NONCOOP,),
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
    static_map=None,
    static_cells=None,
):
    """One lockstep step for an ``[E, A]``-leaved state batch; ``ext_actions``
    is ``[E, A, 2]`` or None.  Same outputs as ``env_step``."""
    return env_step(states, ext_actions, cfg, params, active_policies, sensors,
                    states_in_obs, static_map, static_cells)
