"""Episode auto-reset from a pre-generated scenario pool (port of
:mod:`gym_collision_avoidance_tpu.env.autoreset`).

When an env's episode is over, its whole state is swapped for the fresh
state of the next pool entry.  Every pool entry's fresh state and first
observation are computed once, when the step is built; the per-step reset
is an index gather ``leaf[counter % N]`` and a ``torch.where``.  (The JAX
package picks the row with one-hot MXU dots, a TPU workaround that the port
does not carry over.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.device import resolve_device, torch_dtype
from gym_collision_avoidance_torch.core.state import EnvState, init_state
from gym_collision_avoidance_torch.env.step import env_reset, env_step
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.policies import registry as policies


def state_from_case(cfg: EnvConfig, case, policy_id, dynamics_id=None, rng=None,
                    device=None) -> EnvState:
    """States from ``[E, A, 6]`` case rows ``[px, py, gx, gy, pref_speed,
    radius]``; heading points at the goal (envs/test_cases.py:556-562).

    A ``[E, A, 7]`` row carries a valid flag in column 6
    (``random_cases.scenario_pool_mixed``): invalid agents are parked
    padding that ``is_done = ~valid`` keeps inert.  ``device=None`` means
    CUDA.
    """
    device = resolve_device(device)
    case = torch.as_tensor(np.asarray(case) if not torch.is_tensor(case) else case,
                           dtype=torch_dtype(cfg.dtype), device=device)
    valid = case[..., 6] > 0.5 if case.shape[-1] >= 7 else None
    return init_state(
        cfg,
        pos=case[..., 0:2],
        goal=case[..., 2:4],
        radius=case[..., 5],
        pref_speed=case[..., 4],
        policy_id=policy_id,
        dynamics_id=dynamics_id,
        valid=valid,
        rng=rng,
        device=device,
    )


def make_autoreset_step(
    cfg: EnvConfig,
    pool,
    policy_id,
    active_policies: Tuple[int, ...] = (policies.NONCOOP,),
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
    params=None,
    device=None,
):
    """Build a batched step with reset-where-done semantics.

    Args:
        pool: ``[N, A, 6]`` (or ``[N, A, 7]``) scenario pool.
        policy_id: ``[A]`` int policy ids applied to every episode.
        device: ``None`` means CUDA.

    Returns:
        ``step(state, counter, external=None) -> (state', counter', obs,
        rewards, game_over, info)`` over ``[E]`` envs; ``counter`` is an
        ``[E]`` int32 tensor (give each env a different start, e.g.
        ``arange(E)``).  On reset steps the returned state and obs are the
        new episode's first ones; ``info`` describes the step that ended the
        old episode.
    """
    device = resolve_device(device)
    pool_states = state_from_case(cfg, pool, policy_id, device=device)
    pool_states, pool_obs = env_reset(pool_states, cfg, sensors, states_in_obs)
    N = pool_states.num_envs

    def step(state: EnvState, counter, external=None):
        state, obs, rewards, game_over, info = env_step(
            state, external, cfg, params, active_policies, sensors, states_in_obs,
        )
        pick = (counter % N).long()

        def sel(fresh, old):
            cond = game_over.reshape((-1,) + (1,) * (old.dim() - 1))
            return torch.where(cond, fresh[pick], old)

        rng = state.rng
        state = pool_states.map(sel, state).replace(rng=rng)
        obs = {k: sel(pool_obs[k], v) for k, v in obs.items()}
        counter = counter + game_over.to(counter.dtype)
        return state, counter, obs, rewards, game_over, info

    return step
