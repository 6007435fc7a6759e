"""Episode rollout harness (port of
:mod:`gym_collision_avoidance_tpu.harness.runner`).

The JAX ``lax.scan`` over one env becomes a Python loop over the batched
step; trajectories are stacked ``[T, E, ...]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.core.state import EnvState
from gym_collision_avoidance_torch.env.step import env_step
from gym_collision_avoidance_torch.harness import stats as hstats
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.policies import registry as policies


def rollout(
    state: EnvState,
    cfg: EnvConfig,
    num_steps: int,
    params=None,
    active_policies: Tuple[int, ...] = (policies.NONCOOP,),
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
    collect_obs: bool = False,
    device=None,
):
    """Run ``num_steps`` env steps on ``device`` (``None`` means CUDA; the
    state is moved there), stacking per-step outputs.

    Returns:
        (final_state, traj) where traj is a dict of ``[T, E, ...]`` tensors:
        pos, vel, heading, rewards, game_over, is_at_goal, in_collision,
        ran_out_of_time (+ obs, a dict, if collect_obs).
    """
    state = state.to(resolve_device(device))
    keys = ("pos", "vel", "heading", "rewards", "game_over", "is_at_goal",
            "in_collision", "ran_out_of_time")
    traj = {k: [] for k in keys}
    obs_traj = []
    for _ in range(num_steps):
        state, obs, rewards, game_over, _info = env_step(
            state, None, cfg, params, active_policies, sensors, states_in_obs
        )
        step_out = {"rewards": rewards, "game_over": game_over}
        for k in keys:
            traj[k].append(step_out[k] if k in step_out else getattr(state, k))
        if collect_obs:
            obs_traj.append(obs)
    out = {k: torch.stack(v) for k, v in traj.items()}
    if collect_obs:
        out["obs"] = {k: torch.stack([o[k] for o in obs_traj]) for k in obs_traj[0]}
    return state, out


def episode_stats(traj, cfg: EnvConfig):
    """Per-env episode summary in the reference's schema
    (``experiments/src/env_utils.py:52-88``): steps until game over,
    total reward, outcome flags.  Inputs ``[T, E, ...]``; outputs ``[E]``
    (``[E, A]`` for the per-agent entries)."""
    game_over = traj["game_over"]                                 # [T, E]
    T, E = game_over.shape
    ever = torch.any(game_over, dim=0)
    first_done = torch.argmax(game_over.to(torch.uint8), dim=0)
    steps = torch.where(ever, first_done + 1, torch.full_like(first_done, T))
    step_mask = torch.arange(T, device=game_over.device)[:, None] < steps[None, :]
    total_reward = torch.sum(traj["rewards"] * step_mask[..., None], dim=0)
    per_agent_collision = torch.any(traj["in_collision"] & step_mask[..., None], dim=0)
    at_goal = traj["is_at_goal"][steps - 1, torch.arange(E, device=game_over.device)]
    collision, all_at_goal, any_stuck = hstats.outcome_flags(per_agent_collision, at_goal)
    return {
        "steps": steps,
        "total_reward": total_reward,
        "collision": per_agent_collision,
        "all_at_goal": all_at_goal,
        "any_stuck": any_stuck,
        "time_to_goal": steps.to(traj["rewards"].dtype) * cfg.dt,
    }
