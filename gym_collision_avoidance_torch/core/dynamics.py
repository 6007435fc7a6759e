"""Batched agent dynamics (port of
:mod:`gym_collision_avoidance_tpu.core.dynamics`).

Every model is computed for every agent and the right result selected by
``dynamics_id``.  With ``exact=True`` (``cfg.strict_parity``) the unicycle
step and the ego-frame refresh run in host numpy, copied op for op from the
JAX package's ``_np_*`` functions, which replicate the reference simulator's
scalar arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
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


def _np_wrap(a):
    # identical arithmetic to the reference's scalar while-loop
    # (envs/util.py:141-146) for |a| < 7 pi
    for _ in range(3):
        a = np.where(a >= np.pi, a - 2 * np.pi, a)
        a = np.where(a < -np.pi, a + 2 * np.pi, a)
    return a


def _np_unicycle_step(pos, heading, action, dt, max_turn_rate):
    """Host-numpy unicycle step, ``UnicycleDynamics.step``
    (UnicycleDynamics.py:27-39) operation for operation."""
    sel_speed = action[..., 0]
    dheading = action[..., 1]
    if max_turn_rate is not None:
        # the reference runs this chain in float32 (its actions pass through
        # an f32 buffer, collision_avoidance_env.py:305-306); only the
        # +heading add below promotes to the state dtype
        d32 = np.float32(dheading)
        rate32 = np.clip(d32 / np.float32(dt), -np.float32(max_turn_rate),
                         np.float32(max_turn_rate))
        dheading = (rate32 * np.float32(dt)).astype(np.asarray(heading).dtype)
    sel_heading = _np_wrap(dheading + heading)
    c = np.cos(sel_heading)
    s = np.sin(sel_heading)
    dx = sel_speed * c * dt
    dy = sel_speed * s * dt
    new_pos = pos + np.stack([dx, dy], axis=-1)
    new_vel = np.stack([sel_speed * c, sel_speed * s], axis=-1)
    delta = _np_wrap(sel_heading - heading)
    return new_pos, new_vel, sel_speed, sel_heading, delta


def _np_libm_square(a):
    """The reference's ``x**2`` of a scalar, libm ``pow`` element by element
    (1 ulp off an exact multiply, and off numpy's vectorised square, on
    about 0.1% of inputs)."""
    a = np.asarray(a, np.float64)
    return np.array([math.pow(v, 2.0) for v in a.ravel()]).reshape(a.shape)


def _np_update_ego_frame(pos, goal, heading, vel):
    """Host-numpy ego-frame refresh, ``Agent.get_ref`` (agent.py:329-349)
    and ``Dynamics.update_ego_frame`` (Dynamics.py:24-41) op for op."""
    gd = goal - pos
    dist = np.sqrt(_np_libm_square(gd[..., 0]) + _np_libm_square(gd[..., 1]))
    ref_prll = np.where(
        (dist > 1e-8)[..., None], gd / np.maximum(dist, 1e-30)[..., None], gd
    )
    ref_orth = np.stack([-ref_prll[..., 1], ref_prll[..., 0]], axis=-1)
    ref_angle = np.arctan2(ref_prll[..., 1], ref_prll[..., 0])
    heading_ego = _np_wrap(heading - ref_angle)
    cur_speed = np.sqrt(_np_libm_square(vel[..., 0]) + _np_libm_square(vel[..., 1]))
    vel_ego = np.stack(
        [cur_speed * np.cos(heading_ego), cur_speed * np.sin(heading_ego)],
        axis=-1,
    )
    return ref_prll, ref_orth, dist, heading_ego, vel_ego


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
        # dt reaches the JAX route's callback as an array of the state dtype
        dt_arr = np.asarray(dt, np.float32 if pos.dtype == torch.float32 else np.float64)
        return maths.on_host(
            lambda p, h, a: _np_unicycle_step(p, h, a, dt_arr, max_turn_rate),
            pos, heading, action)
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

    ``exact`` runs the whole refresh in host numpy (strict-parity mode).

    Returns:
        (ref_prll [..., 2], ref_orth [..., 2], dist_to_goal, heading_ego,
         vel_ego [..., 2])
    """
    if exact:
        return maths.on_host(_np_update_ego_frame, pos, goal, heading, vel)
    ref_prll, ref_orth, dist_to_goal = maths.goal_frame_axes(pos, goal)
    ref_angle = maths.arctan2(ref_prll[..., 1], ref_prll[..., 0], exact=exact)
    heading_ego = maths.wrap(heading - ref_angle)
    cur_speed = maths.norm2(vel)
    vel_ego = torch.stack(
        [cur_speed * torch.cos(heading_ego), cur_speed * torch.sin(heading_ego)], dim=-1
    )
    return ref_prll, ref_orth, dist_to_goal, heading_ego, vel_ego
