"""Batched agent dynamics (port of
:mod:`gym_collision_avoidance_tpu.core.dynamics`).

Every model is computed for every agent and the right result selected by
``dynamics_id``.  The JAX package's strict-parity host route is not ported.
"""

from __future__ import annotations

import math

import torch

from gym_collision_avoidance_torch.core import maths

# Dynamics type ids (state.dynamics_id values).
UNICYCLE = 0               # envs/dynamics/UnicycleDynamics.py
UNICYCLE_MAX_TURN_RATE = 1  # envs/dynamics/UnicycleDynamicsMaxTurnRate.py
EXTERNAL = 2               # envs/dynamics/ExternalDynamics.py (no-op step)

DYNAMICS_NAMES = {
    "unicycle": UNICYCLE,
    "unicycle_max_turn_rate": UNICYCLE_MAX_TURN_RATE,
    "external": EXTERNAL,
}

# Hard-coded in the reference (UnicycleDynamicsMaxTurnRate.py:15).
MAX_TURN_RATE = 3.0


def unicycle_step(pos, heading, action, dt, *, max_turn_rate=None, exact=False):
    """One unicycle step (UnicycleDynamics.py:27-39): turn by
    ``action[..., 1]``, then move at ``action[..., 0]`` for ``dt``.

    ``dt`` is a Python float: torch casts it to the operand's dtype, as
    the JAX package's ``jnp.asarray(cfg.dt, dtype)`` does.

    Returns:
        (new_pos [..., 2], new_vel [..., 2], new_speed, new_heading,
         delta_heading)
    """
    if exact:
        raise NotImplementedError(f"cfg.strict_parity: {maths.STRICT_PARITY_ITEM}")
    selected_speed = action[..., 0]
    dheading = action[..., 1]
    if max_turn_rate is not None:
        # The reference runs this clip chain in float32 (its actions pass
        # through an f32 buffer, UnicycleDynamicsMaxTurnRate.py:30-32);
        # only the +heading add below promotes to the state dtype.  The
        # divisor is a tensor: CUDA turns division by a Python scalar into
        # a multiply by its reciprocal, one f32 ulp off true division.
        dt32 = torch.full((), dt, dtype=torch.float32, device=dheading.device)
        rate32 = torch.clamp(dheading.to(torch.float32) / dt32,
                             -max_turn_rate, max_turn_rate)
        dheading = (rate32 * dt).to(heading.dtype)
    selected_heading = maths.wrap(dheading + heading)

    c = torch.cos(selected_heading)
    s = torch.sin(selected_heading)
    dx = selected_speed * c * dt
    dy = selected_speed * s * dt
    new_pos = pos + torch.stack([dx, dy], dim=-1)
    new_vel = torch.stack([selected_speed * c, selected_speed * s], dim=-1)
    delta_heading = maths.wrap(selected_heading - heading)
    return new_pos, new_vel, selected_speed, selected_heading, delta_heading


def turning_dir_update(turning_dir, selected_heading):
    """CADRL turning-direction hysteresis (UnicycleDynamics.py:41-47)."""
    near_zero = torch.abs(turning_dir) < 1e-5
    opposite = turning_dir * selected_heading < 0
    branch_zero = 0.11 * torch.sign(selected_heading)
    branch_opp = torch.clamp(-turning_dir + selected_heading, -math.pi, math.pi)
    branch_decay = torch.sign(turning_dir) * torch.clamp(
        torch.abs(turning_dir) - 0.1, min=0.0
    )
    return torch.where(near_zero, branch_zero,
                       torch.where(opposite, branch_opp, branch_decay))


def new_heading_cmd(action, heading):
    """The wrapped global ``selected_heading`` fed to the turning-dir
    hysteresis (UnicycleDynamics.py:28,43-47)."""
    return maths.wrap(action[..., 1] + heading)


def step_all(pos, vel, speed, heading, delta_heading, turning_dir, dynamics_id,
             action, dt, exact=False):
    """Apply every dynamics model and select per agent by ``dynamics_id``;
    EXTERNAL agents keep their state.

    Returns:
        (pos, vel, speed, heading, delta_heading, turning_dir) after the step.
    """
    u_pos, u_vel, u_speed, u_heading, u_dh = unicycle_step(
        pos, heading, action, dt, exact=exact
    )
    m_pos, m_vel, m_speed, m_heading, m_dh = unicycle_step(
        pos, heading, action, dt, max_turn_rate=MAX_TURN_RATE, exact=exact
    )

    is_uni = dynamics_id == UNICYCLE
    moving = is_uni | (dynamics_id == UNICYCLE_MAX_TURN_RATE)
    is_uni_v = is_uni[..., None]
    moving_v = moving[..., None]

    new_pos = torch.where(moving_v, torch.where(is_uni_v, u_pos, m_pos), pos)
    new_vel = torch.where(moving_v, torch.where(is_uni_v, u_vel, m_vel), vel)
    new_speed = torch.where(moving, torch.where(is_uni, u_speed, m_speed), speed)
    new_heading = torch.where(moving, torch.where(is_uni, u_heading, m_heading), heading)
    new_dh = torch.where(moving, torch.where(is_uni, u_dh, m_dh), delta_heading)

    # turning_dir is only maintained by plain UnicycleDynamics.
    new_turning = torch.where(
        is_uni,
        turning_dir_update(turning_dir, new_heading_cmd(action, heading)),
        turning_dir,
    )
    return new_pos, new_vel, new_speed, new_heading, new_dh, new_turning


def update_ego_frame(pos, goal, heading, vel, exact: bool = False):
    """Recompute the goal-aligned ego frame (Dynamics.py:24-41).

    Returns:
        (ref_prll [..., 2], ref_orth [..., 2], dist_to_goal, heading_ego,
         vel_ego [..., 2])
    """
    ref_prll, ref_orth, dist_to_goal = maths.goal_frame_axes(pos, goal)
    ref_angle = maths.arctan2(ref_prll[..., 1], ref_prll[..., 0], exact=exact)
    heading_ego = maths.wrap(heading - ref_angle)
    cur_speed = maths.norm2(vel)
    vel_ego = torch.stack(
        [cur_speed * torch.cos(heading_ego), cur_speed * torch.sin(heading_ego)], dim=-1
    )
    return ref_prll, ref_orth, dist_to_goal, heading_ego, vel_ego
