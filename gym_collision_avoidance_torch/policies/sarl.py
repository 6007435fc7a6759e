"""SARL internal policy: a one-step lookahead over 81 holonomic candidates,
scored by the attention-pooling value net (``models/sarl.py``).

CrowdNav's ``MultiHumanRL.predict`` in its eval phase
(``crowd_nav/policy/multi_human_rl.py``, ``cadrl.py``; holonomic kinematics,
``query_env = false``), for every agent of the batch at once:

* each agent sees every other valid agent within the sensing horizon, the
  candidates of ``policies/cadrl.py:_select_others`` with no slot cap; an
  invalid agent (padding, parked far out) sees none, so that its values,
  which no action reads, stay finite;
* candidates (``build_action_space``): the stop (0, 0), then for each of 16
  rotations 2 pi m / 16 (the outer loop) each of 5 speeds
  ``v_pref (e^((k+1)/5) - 1) / (e - 1)``, as velocities;
* the ego moves to ``p' = p + a dt``; each other moves on at its velocity;
* each (candidate, other) pair's joint state is rotated into the ego's goal
  frame, ``rot = atan2(g - p')`` (``cadrl.py:rotate``): 13 features
  ``[dg, v_pref, 0, r, vx, vy, px1, py1, vx1, vy1, r1, da, r + r1]``;
* the reward (``compute_reward``): -0.25 if a gap ``|p' - p_j'| - r - r_j``
  is below 0, else 1 if ``|p' - g| < r``, else ``(d_min - 0.2) 0.5 dt``
  if the least gap is below 0.2, else 0;
* the first candidate of the largest ``reward + 0.9^(dt v_pref) V``; an
  agent within its radius of its goal stops.

The env's unicycle step takes the chosen velocity as (speed, heading change
to its direction), the stop as (0, 0).  ``dt`` is the env's, as CrowdNav
sets the policy's time step from its env.  The value net's raw outputs
``[E, A, 81]`` come out of one call of ``models.sarl.forward_raw`` a step.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gym_collision_avoidance_torch.core import maths
from gym_collision_avoidance_torch.models import sarl as sarl_net
from gym_collision_avoidance_torch.utils import profiling

PARAMS_KEY = "sarl"

GAMMA = 0.9
NUM_ROTATIONS = 16
NUM_SPEEDS = 5
COLLISION_REWARD = -0.25
GOAL_REWARD = 1.0
DISCOMFORT_DIST = 0.2
DISCOMFORT_FACTOR = 0.5


@functools.lru_cache(maxsize=None)
def _tables(dtype, device):
    """``(speed_scales [5], cos [16], sin [16], rotations [16])`` in
    ``dtype``, each computed in float64 and rounded once."""
    k = np.arange(1, NUM_SPEEDS + 1)
    scales = (np.exp(k / NUM_SPEEDS) - 1.0) / (np.e - 1.0)
    rot = np.linspace(0.0, 2.0 * np.pi, NUM_ROTATIONS, endpoint=False)
    return tuple(torch.as_tensor(t, dtype=dtype, device=device)
                 for t in (scales, np.cos(rot), np.sin(rot), rot))


@functools.lru_cache(maxsize=None)
def _others_index(num_agents, device):
    """``[A, A - 1]``: agent h's others, ascending."""
    k = torch.arange(num_agents - 1, device=device)
    h = torch.arange(num_agents, device=device)[:, None]
    return k + (k >= h).long()


def _candidates(pref_speed):
    """``(speed, vx, vy)`` ``[E, A, 81]`` of every agent's candidates."""
    scales, cos, sin, _ = _tables(pref_speed.dtype, pref_speed.device)
    speed = pref_speed[..., None, None] * scales                       # [E, A, 1, 5]
    speed = speed.expand(*pref_speed.shape, NUM_ROTATIONS, NUM_SPEEDS)
    vx, vy = speed * cos[:, None], speed * sin[:, None]
    zero = torch.zeros_like(pref_speed)[..., None]
    return tuple(torch.cat([zero, t.flatten(-2)], dim=-1) for t in (speed, vx, vy))


def _lookahead(state, cfg):
    """``(pairs [E, A, 81, P, 13], present [E, A, 1, P], self_state
    [E, A, 81, 6], reward [E, A, 81], speed [E, A, 81])``."""
    dt = cfg.dt
    A = state.pos.shape[1]
    others = _others_index(A, state.pos.device)
    pos, vel, r = state.pos, state.vel, state.radius
    opos, ovel, orad = pos[:, others], vel[:, others], r[:, others]    # [E, A, P, ...]
    present = (state.valid[:, :, None] & state.valid[:, others]
               & (maths.norm2(opos - pos[:, :, None]) <= cfg.sensing_horizon))

    speed, vx, vy = _candidates(state.pref_speed)
    px = pos[..., 0, None] + vx * dt                                   # [E, A, 81]
    py = pos[..., 1, None] + vy * dt
    gx, gy = state.goal[..., 0, None] - px, state.goal[..., 1, None] - py
    rot = torch.atan2(gy, gx)
    c, s = torch.cos(rot), torch.sin(rot)
    dg = maths.l2norm(gx, gy)

    ox = (opos[..., 0] + ovel[..., 0] * dt)[:, :, None]                # [E, A, 1, P]
    oy = (opos[..., 1] + ovel[..., 1] * dt)[:, :, None]
    ovx, ovy = ovel[..., 0][:, :, None], ovel[..., 1][:, :, None]
    c4, s4 = c[..., None], s[..., None]
    dx, dy = ox - px[..., None], oy - py[..., None]                    # [E, A, 81, P]
    da = maths.l2norm(dx, dy)
    r3, r4, r1 = r[..., None], r[..., None, None], orad[:, :, None]

    self_state = torch.stack([dg, state.pref_speed[..., None].expand_as(dg),
                              torch.zeros_like(dg), r3.expand_as(dg), vx * c + vy * s,
                              vy * c - vx * s], dim=-1)
    other = torch.stack([t.expand(da.shape) for t in (
        dx * c4 + dy * s4, dy * c4 - dx * s4, ovx * c4 + ovy * s4, ovy * c4 - ovx * s4,
        r1, da, r4 + r1)], dim=-1)
    pairs = torch.cat([self_state[..., None, :].expand(*da.shape, sarl_net.SELF_DIM), other],
                      dim=-1)

    there = present[:, :, None]
    gap = da - r4 - r1
    collide = (there & (gap < 0)).any(dim=-1)
    d_min = torch.where(there, gap, math.inf).amin(dim=-1)
    zero = torch.zeros_like(dg)
    reward = torch.where(d_min < DISCOMFORT_DIST,
                         (d_min - DISCOMFORT_DIST) * DISCOMFORT_FACTOR * dt, zero)
    reward = torch.where(dg < r3, GOAL_REWARD, reward)
    reward = torch.where(collide, COLLISION_REWARD, reward)
    return pairs, there, self_state, reward, speed


def _net(params):
    if params is None or PARAMS_KEY not in params:
        raise ValueError("SARL policy requires params['sarl'] (models.sarl.load_params())")
    return params[PARAMS_KEY]


def sarl_values(state, cfg, params):
    """``(values [E, A, 81], speed [E, A, 81])``: every candidate's
    ``reward + 0.9^(dt v_pref) V`` and its speed."""
    with profiling.span("gca.sarl.lookahead"):
        pairs, present, self_state, reward, speed = _lookahead(state, cfg)
    with profiling.span("gca.sarl.net"):
        raw = sarl_net.forward_raw(_net(params), pairs, present, self_state)
    discount = torch.pow(GAMMA, cfg.dt * state.pref_speed)[..., None]
    return reward + discount * raw, speed


def sarl_kernel(state, cfg, params):
    """``[E, A, 2]`` (speed, delta heading) of SARL for every agent."""
    values, speed = sarl_values(state, cfg, params)
    best = torch.argmax(values, dim=-1)
    rotations = _tables(speed.dtype, speed.device)[3]
    heading = rotations[torch.clamp(best - 1, min=0) // NUM_SPEEDS]
    chosen = torch.gather(speed, -1, best[..., None])[..., 0]
    action = torch.stack([chosen, maths.wrap(heading - state.heading)], dim=-1)
    arrived = maths.norm2(state.goal - state.pos) < state.radius
    stop = (best == 0) | arrived
    return torch.where(stop[..., None], torch.zeros_like(action), action)
