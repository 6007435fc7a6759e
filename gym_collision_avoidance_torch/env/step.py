"""The environment step over a batch of envs (port of
:mod:`gym_collision_avoidance_tpu.env.step`).

The JAX step is written for one env and vmapped; this one takes
``[E, A, ...]`` states directly.  Order of a step, as in the reference
(``CollisionAvoidanceEnv.step``, collision_avoidance_env.py:156-234):

1. action selection,
2. dynamics with done-freezing and ``was_*`` latching,
3. rewards from the new positions, with collision latching (kernel K1
   and its reward epilogue, one launch on the card),
4. sensing and observation assembly,
5. done flags and the per-env game-over reduction.

Phases 1-4 are marked ``gca.policy``, ``gca.dynamics``, ``gca.rewards`` and
``gca.observe`` in a profiler's trace (:func:`utils.profiling.span`).

``static_map`` (``[H, W]`` bool, :func:`maps.grid.load_static_map`) adds
wall collisions when ``cfg.use_static_map`` and feeds the dense laserscan
and the occupancy grid; ``static_cells`` (``[S, 2]``,
:func:`maps.grid.occupied_cell_list`) switches the laserscan to
``laserscan_sparse``.  Pass both as device tensors to skip a copy a step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from gym_collision_avoidance_torch import config as cfg_mod
from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core import dynamics as dyn
from gym_collision_avoidance_torch.core.device import as_device_tensor
from gym_collision_avoidance_torch.core.state import EnvState
from gym_collision_avoidance_torch.maps import grid as map_grid
from gym_collision_avoidance_torch.obs import sensors as sensors_mod
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.ops import pairwise
from gym_collision_avoidance_torch.policies import registry as policies
from gym_collision_avoidance_torch.utils import profiling


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


def _on_device(x, dtype, device):
    return None if x is None else as_device_tensor(x, dtype, device)


def _compute_rewards(state: EnvState, cfg: EnvConfig, static_map=None):
    """Reward shaping + collision latching
    (envs/collision_avoidance_env.py:394-456): one launch of kernel K1 with
    its reward epilogue on the card
    (:func:`gym_collision_avoidance_torch.ops.pairwise.pairwise_rewards`),
    after the wall test on map paths."""
    wall = None
    if cfg.use_static_map and static_map is not None:
        wall = map_grid.wall_collisions(
            static_map, state.pos, state.radius, state.valid, cfg).contiguous()
    _, _, r, in_collision = pairwise.pairwise_rewards(
        *(t.contiguous() for t in (
            state.pos, state.radius, state.valid, state.is_at_goal, state.was_at_goal_already,
            state.was_in_collision_already, state.in_collision, state.past_actions)),
        wall, cfg)
    return state.replace(in_collision=in_collision), r


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


def _equipped_mask(idx, num_agents: int, device):
    """``[A]`` bool: which agents carry a subset-equipped sensor."""
    m = torch.zeros(num_agents, dtype=torch.bool, device=device)
    m[list(idx)] = True
    return m


def _sense_and_observe(state: EnvState, cfg: EnvConfig, sensors,
                       states_in_obs: Sequence[str], static_map=None, static_cells=None):
    """Sensor pass + obs assembly (collision_avoidance_env.py:555-575).

    Returns (state, obs, sense_info); ``sense_info`` holds the ``[E]``
    ``laserscan_exactness_overflow`` guard of the fast laserscan routes.
    Agents outside a ``(name, idx)`` subset keep their sensor state."""
    E, A = state.pos.shape[:2]
    device = state.pos.device
    spec = normalize_sensor_spec(sensors, A)
    for name in spec:
        if name not in ("other_agents_states", "laserscan", "occupancy_grid"):
            raise ValueError(f"unknown sensor {name!r}")
    static_map = _on_device(static_map, torch.bool, device)
    static_cells = _on_device(static_cells, torch.int32, device)
    sensed = {}
    sense_info = {}
    needs_map = ("laserscan" in spec and static_cells is None) or "occupancy_grid" in spec
    if needs_map:
        if static_map is None or not cfg.use_static_map:
            raise ValueError(
                "laserscan/occupancy_grid sensors need cfg.use_static_map=True and a "
                "static_map array (or static_cells for the sparse laserscan)")
        dynamic_map = map_grid.stamp_agents(static_map, state.pos, state.radius,
                                            state.valid, cfg)
    if "laserscan" in spec:
        idx = spec["laserscan"]
        if static_cells is not None:
            ranges_e, laser_ovf = sensors_mod.laserscan_sparse(
                state, cfg, static_cells, ego_idx=idx, return_overflow=True)
            if (cfg.laserscan_entry_window is not None
                    or cfg.laserscan_num_candidate_discs is not None):
                # True where this step's ranges may differ from the full pass
                sense_info["laserscan_exactness_overflow"] = laser_ovf
        else:
            ranges_e = sensors_mod.laserscan(state, cfg, dynamic_map, ego_idx=idx)
        if idx is None:
            ranges, equipped = ranges_e, None
        else:
            # unequipped rows read the maximum range; they are never used
            ranges = torch.full((E, A, ranges_e.shape[-1]), sensors_mod.LASER_MAX_RANGE,
                                dtype=ranges_e.dtype, device=device)
            ranges[:, list(idx)] = ranges_e
            equipped = _equipped_mask(idx, A, device)
        hist = state.laserscan_history
        rolled = torch.cat([ranges[:, :, None, :], hist[:, :, :-1, :]], dim=2)
        # the first measurement fills the whole history (LaserScanSensor.py:84-88)
        first = (state.laserscan_count == 0)[..., None, None]
        hist_new = torch.where(first, ranges[:, :, None, :].expand_as(rolled), rolled)
        count = state.laserscan_count + 1
        if equipped is not None:
            hist_new = torch.where(equipped[:, None, None], hist_new, hist)
            count = torch.where(equipped, count, state.laserscan_count)
        state = state.replace(laserscan_history=hist_new, laserscan_count=count)
        sensed["laserscan"] = hist_new
    if "occupancy_grid" in spec:
        og = sensors_mod.occupancy_grid(state, cfg, dynamic_map)
        idx = spec["occupancy_grid"]
        if idx is not None:
            og = og & _equipped_mask(idx, A, device)[:, None, None]
        sensed["occupancy_grid"] = og
    if "other_agents_states" in spec:
        rows, closest, counts = sensors_mod.other_agents_states(state, cfg)
        idx = spec["other_agents_states"]
        if idx is not None:
            eq = _equipped_mask(idx, A, device)
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
    return state, obs, sense_info


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


def env_step(
    state: EnvState,
    ext_actions: Optional[torch.Tensor],
    cfg: EnvConfig,
    params=None,
    active_policies: Tuple[int, ...] = (policies.NONCOOP,),
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
    static_map=None,
    static_cells=None,
):
    """Advance every env of the batch by one timestep.

    Args:
        state: ``[E, A]``-leaved :class:`EnvState`.
        ext_actions: ``[E, A, 2]`` external actions, or None if no agent has
            an external policy.
        active_policies: policy ids present in the batch.
        static_map / static_cells: see the module docstring.

    Returns:
        (new_state, obs dict, rewards [E, A], game_over [E] bool, info dict);
        with a fast laserscan route, ``info["laserscan_exactness_overflow"]``
        is ``[E]`` bool.
    """
    # StaticPolicy pins its goal to its position every step it is queried
    # (StaticPolicy.py:21); done agents are not queried.
    if policies.STATIC in active_policies:
        pin = (state.policy_id == policies.STATIC) & ~state.is_done
        state = state.replace(goal=torch.where(pin[..., None], state.pos, state.goal))

    with profiling.span("gca.policy"):
        actions = policies.compute_actions(state, ext_actions, cfg, params, active_policies)
        if cfg.cast_actions_to_f32:
            # The reference buffers all actions through a float32 array
            # (envs/collision_avoidance_env.py:304-306).
            actions = actions.to(torch.float32).to(state.pos.dtype)

    static_map = _on_device(static_map, torch.bool, state.pos.device)
    with profiling.span("gca.dynamics"):
        state = _take_actions(state, actions, cfg)
    with profiling.span("gca.rewards"):
        state, rewards = _compute_rewards(state, cfg, static_map)
    with profiling.span("gca.observe"):
        state, obs, sense_info = _sense_and_observe(state, cfg, sensors, states_in_obs,
                                                    static_map, static_cells)
    state, which_done, game_over = _check_dones(state, cfg)
    state = state.replace(episode_step=state.episode_step + 1)

    info = {
        "which_agents_done": which_done,
        "which_agents_learning": policies._isin(
            state.policy_id, policies.STILL_LEARNING_POLICIES
        ),
        **sense_info,
    }
    return state, obs, rewards, game_over, info


def env_reset(
    state: EnvState,
    cfg: EnvConfig,
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
    static_map=None,
    static_cells=None,
):
    """The first observation of freshly-initialized states
    (``reset`` -> ``_get_obs``, collision_avoidance_env.py:236-282)."""
    state, obs, _sense_info = _sense_and_observe(state, cfg, sensors, states_in_obs,
                                                 static_map, static_cells)
    return state, obs
