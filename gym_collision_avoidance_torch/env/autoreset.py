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
from gym_collision_avoidance_torch.core.device import (
    as_device_tensor,
    params_to_device,
    resolve_device,
    torch_dtype,
)
from gym_collision_avoidance_torch.core.state import EnvState, init_state
from gym_collision_avoidance_torch.env.step import env_reset, env_step
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.policies import registry as policies
from gym_collision_avoidance_torch.utils import profiling


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
    static_map=None,
    static_cells=None,
    return_info: bool = False,
):
    """Build a batched step with reset-where-done semantics.

    Args:
        pool: ``[N, A, 6]`` (or ``[N, A, 7]``) scenario pool.
        policy_id: ``[A]`` int policy ids applied to every episode.
        params: policy parameters (``{"ga3c_cadrl": GA3CCADRL}``, RVO's
            ``"rvo_use_noncoop"`` flags); copied to the device once here.
        device: ``None`` means CUDA.
        static_map / static_cells: map inputs of laserscan and occupancy
            configs, as in ``env_step``; moved to the device once here.
        return_info: also return ``env_step``'s info dict.  A config with a
            fast laserscan route (``laserscan_entry_window`` or
            ``laserscan_num_candidate_discs``) is exact only while the
            info's ``laserscan_exactness_overflow`` guard is False, so such
            a step must be built with ``return_info=True``.

    Returns:
        ``step(state, counter, external=None) -> (state', counter', obs,
        rewards, game_over[, info])`` over ``[E]`` envs; ``counter`` is an
        ``[E]`` int32 tensor (give each env a different start, e.g.
        ``arange(E)``).  On reset steps the returned state and obs are the
        new episode's first ones; ``info`` describes the step that ended the
        old episode, whose exactness the guard certifies.  A profiler's
        trace marks each call ``gca.step`` and its reset pick ``gca.reset``.
    """
    device = resolve_device(device)
    fast_laser = (cfg.laserscan_entry_window is not None
                  or cfg.laserscan_num_candidate_discs is not None)
    if (fast_laser and static_cells is not None and not return_info
            and any((s if isinstance(s, str) else s[0]) == "laserscan" for s in sensors)):
        raise ValueError(
            "cfg enables a conditionally-exact laserscan fast path "
            "(laserscan_entry_window / laserscan_num_candidate_discs); build the "
            "autoreset step with return_info=True and check "
            "info['laserscan_exactness_overflow'] every step")
    # the weights and flags go to the device once, not in every step
    params = params_to_device(params, device)
    if static_map is not None:
        static_map = as_device_tensor(static_map, torch.bool, device)
    if static_cells is not None:
        static_cells = as_device_tensor(static_cells, torch.int32, device)
    pool_states = state_from_case(cfg, pool, policy_id, device=device)
    pool_states, pool_obs = env_reset(pool_states, cfg, sensors, states_in_obs,
                                      static_map, static_cells)
    N = pool_states.num_envs

    def step(state: EnvState, counter, external=None):
        with profiling.span("gca.step"):
            state, obs, rewards, game_over, info = env_step(
                state, external, cfg, params, active_policies, sensors, states_in_obs,
                static_map, static_cells,
            )
            with profiling.span("gca.reset"):
                pick = (counter % N).long()

                def sel(fresh, old):
                    cond = game_over.reshape((-1,) + (1,) * (old.dim() - 1))
                    return torch.where(cond, fresh[pick], old)

                rng = state.rng
                state = pool_states.map(sel, state).replace(rng=rng)
                obs = {k: sel(pool_obs[k], v) for k, v in obs.items()}
                counter = counter + game_over.to(counter.dtype)
        if return_info:
            return state, counter, obs, rewards, game_over, info
        return state, counter, obs, rewards, game_over

    return step
