"""The environment step over a batch of envs (port of
:mod:`gym_collision_avoidance_tpu.env.step`).

The JAX step is written for one env and vmapped; this one takes
``[E, A, ...]`` states directly.  Order of a step, as in the reference
(``CollisionAvoidanceEnv.step``, collision_avoidance_env.py:156-234):

1. action selection,
2. dynamics with done-freezing and ``was_*`` latching,
3. rewards from the new positions, with collision latching (kernel K1),
4. sensing and observation assembly,
5. done flags and the per-env game-over reduction.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from gym_collision_avoidance_torch import config as cfg_mod
from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core import dynamics as dyn
from gym_collision_avoidance_torch.core.state import MAPS_ITEM, EnvState
from gym_collision_avoidance_torch.obs import sensors as sensors_mod
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.ops import pairwise
from gym_collision_avoidance_torch.policies import registry as policies


def _take_actions(state: EnvState, actions: torch.Tensor, cfg: EnvConfig) -> EnvState:
    """``Agent.take_action`` on every agent (envs/agent.py:192-241)."""
    dt = cfg.dt  # a Python float: cast to each operand's dtype

    # Done freeze & was_* latching (envs/agent.py:202-209).
    frozen = state.is_at_goal | state.ran_out_of_time | state.in_collision
    active = ~frozen & state.valid
    active_v = active[..., None]
    valid_v = state.valid[..., None]
    was_at_goal_already = state.was_at_goal_already | (frozen & state.is_at_goal)
    was_in_collision_already = state.was_in_collision_already | (
        frozen & state.in_collision
    )

    # Past-action ring buffer, rolled only for active agents
    # (envs/agent.py:212-213).
    rolled_actions = torch.cat([actions[..., None, :], state.past_actions[..., :-1, :]], dim=-2)
    past_actions = torch.where(active_v[..., None], rolled_actions, state.past_actions)

    new_pos, new_vel, new_speed, new_heading, new_dh, new_turning = dyn.step_all(
        state.pos, state.vel, state.speed, state.heading, state.delta_heading,
        state.turning_dir, state.dynamics_id, actions, dt, exact=cfg.strict_parity,
    )
    pos = torch.where(active_v, new_pos, state.pos)
    # Frozen agents get their velocity zeroed (envs/agent.py:207).
    vel = torch.where(active_v, new_vel, torch.zeros_like(state.vel))
    vel = torch.where(valid_v, vel, state.vel)
    speed = torch.where(active, new_speed, state.speed)
    heading = torch.where(active, new_heading, state.heading)
    delta_heading = torch.where(active, new_dh, state.delta_heading)
    turning_dir = torch.where(active, new_turning, state.turning_dir)

    # Ego-frame refresh (envs/agent.py:225); frozen agents keep stale values.
    ref_prll, ref_orth, dist_to_goal, heading_ego, vel_ego = dyn.update_ego_frame(
        pos, state.goal, heading, vel, exact=cfg.strict_parity
    )
    ref_prll = torch.where(active_v, ref_prll, state.ref_prll)
    ref_orth = torch.where(active_v, ref_orth, state.ref_orth)
    dist_to_goal = torch.where(active, dist_to_goal, state.dist_to_goal)
    heading_ego = torch.where(active, heading_ego, state.heading_ego_frame)
    vel_ego = torch.where(active_v, vel_ego, state.vel_ego_frame)

    # Goal check on the new position (envs/agent.py:150-153, squared form).
    diff = pos - state.goal
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    is_at_goal = torch.where(active, d2 <= cfg.near_goal_threshold**2, state.is_at_goal)

    # Past-velocity ring buffer, rolled for everyone valid: frozen agents
    # store their zeroed velocity (envs/agent.py:208, 232).
    past_vel = torch.cat([vel[..., None, :], state.past_vel[..., :-1, :]], dim=-2)
    past_vel = torch.where(valid_v[..., None], past_vel, state.past_vel)

    # Timers (envs/agent.py:235-239): only active agents burn time.
    time_remaining = torch.where(active, state.time_remaining - dt, state.time_remaining)
    ran_out_of_time = torch.where(active, time_remaining <= 0.0, state.ran_out_of_time)
    t = torch.where(active, state.t + dt, state.t)
    step_num = torch.where(active, state.step_num + 1, state.step_num)

    return state.replace(
        pos=pos, vel=vel, speed=speed, heading=heading, delta_heading=delta_heading,
        turning_dir=turning_dir, ref_prll=ref_prll, ref_orth=ref_orth,
        dist_to_goal=dist_to_goal, heading_ego_frame=heading_ego, vel_ego_frame=vel_ego,
        past_actions=past_actions, past_vel=past_vel, is_at_goal=is_at_goal,
        was_at_goal_already=was_at_goal_already,
        was_in_collision_already=was_in_collision_already,
        time_remaining=time_remaining, ran_out_of_time=ran_out_of_time, t=t,
        step_num=step_num,
    )


def _compute_rewards(state: EnvState, cfg: EnvConfig):
    """Reward shaping + collision latching
    (envs/collision_avoidance_env.py:394-456).  The pairwise geometry is
    kernel K1 (:mod:`gym_collision_avoidance_torch.ops.pairwise`)."""
    collision_with_agent, dist_nearest = pairwise.pairwise_collisions(
        state.pos.contiguous(), state.radius.contiguous(), state.valid.contiguous()
    )
    # Wall collisions need static maps (ROADMAP.md §1 item 11): always False.

    r = torch.full(state.radius.shape, cfg.reward_time_step,
                   dtype=state.pos.dtype, device=state.pos.device)
    goal_now = state.is_at_goal & ~state.was_at_goal_already
    r = torch.where(goal_now, torch.full_like(r, cfg.reward_at_goal), r)

    eligible = ~state.is_at_goal & ~state.was_in_collision_already
    hit_agent = eligible & collision_with_agent
    r = torch.where(hit_agent, torch.full_like(r, cfg.reward_collision_with_agent), r)

    no_hit = eligible & ~collision_with_agent
    close = no_hit & (dist_nearest <= cfg.getting_close_range)
    # The -0.1 - d/2 shaping is hard-coded in the reference (":438-440").
    r = torch.where(close, cfg.reward_getting_close - dist_nearest / 2.0, r)
    wiggly = no_hit & (torch.abs(state.past_actions[..., 0, 1]) > cfg.wiggly_behavior_threshold)
    r = torch.where(wiggly, r + cfg.reward_wiggly_behavior, r)

    # Clip to the min/max possible single-step reward (":451-453, 589-599").
    possible = [
        cfg.reward_at_goal,
        cfg.reward_collision_with_agent,
        cfg.reward_time_step,
        cfg.reward_collision_with_wall,
        cfg.reward_wiggly_behavior,
    ]
    r = torch.clamp(r, min(possible), max(possible))
    r = torch.where(state.valid, r, torch.zeros_like(r))

    return state.replace(in_collision=state.in_collision | hit_agent), r


def normalize_sensor_spec(sensors, num_agents: int):
    """Parse the sensors argument into ``{name: ego_idx or None}``: a name
    equips every agent, a ``(name, (i0, i1, ...))`` pair only the listed
    ones (a full-coverage tuple collapses to None)."""
    spec = {}
    for entry in sensors:
        if isinstance(entry, str):
            spec[entry] = None
        else:
            name, idx = entry
            idx = tuple(int(i) for i in idx)
            spec[name] = None if idx == tuple(range(num_agents)) else idx
    return spec


def _sense_and_observe(state: EnvState, cfg: EnvConfig, sensors,
                       states_in_obs: Sequence[str]):
    """Sensor pass + obs assembly (collision_avoidance_env.py:555-575).
    Only the other-agents sensor is ported."""
    A = state.num_agents
    spec = normalize_sensor_spec(sensors, A)
    for name in spec:
        if name != "other_agents_states":
            raise NotImplementedError(f"sensor {name!r}: {MAPS_ITEM}")
    sensed = {}
    if "other_agents_states" in spec:
        rows, closest, counts = sensors_mod.other_agents_states(state, cfg)
        idx = spec["other_agents_states"]
        if idx is not None:
            eq = torch.zeros(A, dtype=torch.bool, device=state.pos.device)
            eq[list(idx)] = True
            rows = torch.where(eq[:, None, None], rows, state.sensed_others)
            closest = torch.where(eq[:, None], closest, state.other_agent_states)
            counts = torch.where(eq, counts, state.num_other_agents_observed)
        sensed["other_agents_states"] = rows
        state = state.replace(
            other_agent_states=closest,
            sensed_others=rows,
            num_other_agents_observed=counts,
        )
    obs = obs_spec.build_observation(state, cfg, sensed, states_in_obs)
    return state, obs


def _check_dones(state: EnvState, cfg: EnvConfig):
    """Done flags + per-env game over (collision_avoidance_env.py:514-553)."""
    which_done = state.is_at_goal | state.ran_out_of_time | state.in_collision
    is_done = which_done | ~state.valid

    if cfg.done_mode == cfg_mod.DONE_MODE_EVALUATE:
        game_over = torch.all(is_done, dim=-1)
    elif cfg.done_mode == cfg_mod.DONE_MODE_SINGLE_AGENT:
        game_over = which_done[..., 0]
    elif cfg.done_mode == cfg_mod.DONE_MODE_LEARNING:
        learning = policies._isin(state.policy_id, policies.STILL_LEARNING_POLICIES)
        game_over = torch.all(is_done | ~learning, dim=-1)
    else:
        raise ValueError(f"unknown done mode {cfg.done_mode}")

    return state.replace(is_done=is_done), which_done, game_over


def _check_supported(cfg: EnvConfig):
    if cfg.use_static_map:
        raise NotImplementedError(f"cfg.use_static_map: {MAPS_ITEM}")


def env_step(
    state: EnvState,
    ext_actions: Optional[torch.Tensor],
    cfg: EnvConfig,
    params=None,
    active_policies: Tuple[int, ...] = (policies.NONCOOP,),
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
):
    """Advance every env of the batch by one timestep.

    Args:
        state: ``[E, A]``-leaved :class:`EnvState`.
        ext_actions: ``[E, A, 2]`` external actions, or None if no agent has
            an external policy.
        active_policies: policy ids present in the batch.

    Returns:
        (new_state, obs dict, rewards [E, A], game_over [E] bool, info dict)
    """
    _check_supported(cfg)
    # StaticPolicy pins its goal to its position every step it is queried
    # (StaticPolicy.py:21); done agents are not queried.
    if policies.STATIC in active_policies:
        pin = (state.policy_id == policies.STATIC) & ~state.is_done
        state = state.replace(goal=torch.where(pin[..., None], state.pos, state.goal))

    actions = policies.compute_actions(state, ext_actions, cfg, params, active_policies)
    if cfg.cast_actions_to_f32:
        # The reference buffers all actions through a float32 array
        # (envs/collision_avoidance_env.py:304-306).
        actions = actions.to(torch.float32).to(state.pos.dtype)

    state = _take_actions(state, actions, cfg)
    state, rewards = _compute_rewards(state, cfg)
    state, obs = _sense_and_observe(state, cfg, sensors, states_in_obs)
    state, which_done, game_over = _check_dones(state, cfg)
    state = state.replace(episode_step=state.episode_step + 1)

    info = {
        "which_agents_done": which_done,
        "which_agents_learning": policies._isin(
            state.policy_id, policies.STILL_LEARNING_POLICIES
        ),
    }
    return state, obs, rewards, game_over, info


def env_reset(
    state: EnvState,
    cfg: EnvConfig,
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
):
    """The first observation of freshly-initialized states
    (``reset`` -> ``_get_obs``, collision_avoidance_env.py:236-282)."""
    _check_supported(cfg)
    return _sense_and_observe(state, cfg, sensors, states_in_obs)
