"""SA-CADRL internal policy: the one-step lookahead over 47 candidate
actions (port of :mod:`gym_collision_avoidance_tpu.policies.cadrl`).

The reference's ``CADRLPolicy`` over the legacy ``NN_navigation_value`` stack
(CADRLPolicy.py:27-167, nn_navigation_value_multi.py): each ego agent picks
its <= 3 closest others, builds 47 candidate (speed, heading) actions (38
with a validity mask in ``rotate_constr`` mode), propagates itself and the
others one lookahead step, prunes colliding candidates, adds shaped rewards
(and the passing-side penalty), encodes every propagated state in its
agent-centric frame and takes the argmax of reward plus discounted value.
On the card, in ``no_constr`` mode with no passing side, everything after
the other selection up to the encoded batch is one launch of
``csrc/cadrl_lookahead.cu`` (:func:`_takes_kernel`); elsewhere it is
:func:`_lookahead_plain`, the plain version the kernel is held to.

The JAX package writes this for one ego agent and vmaps it over agents and
envs; here every function carries the batch axes ``[E, A]`` (ego agent h on
the second axis) in front, and the value net runs once on the whole
``[E, A, 47, 31]`` batch.  Gathers stand where the JAX package sums one-hot
products (its TPU idiom); a one-hot sum turns -0.0 into +0.0, so every gather
adds 0.0.  The quotients by closed-over constants follow the compiled JAX
step: ``round(d * 100) / 100`` is a product with 0.01 and the filtered past
velocity a product with ``1 / (2 dt)``, both rounded to the dtype.

Constants from CADRL/scripts/multi/global_var.py:5-62.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gym_collision_avoidance_torch.core import maths
from gym_collision_avoidance_torch.maps.grid import reciprocal
from gym_collision_avoidance_torch.models import cadrl as cadrl_net
from gym_collision_avoidance_torch.obs.sensors import _lex_rank
from gym_collision_avoidance_torch.ops import cadrl_lookahead

PARAMS_KEY = "cadrl"

GAMMA = 0.97
DT_NORMAL = 0.5
COLLISION_COST = -0.25
DIST_2_GOAL_THRES = 0.05
GETTING_CLOSE_RANGE = 0.2
EPS = 1e-5
DT_FORWARD_DEFAULT = 1.0   # NN_navigation_value.dt_forward (:210)
RADIUS_BUFFER = 0.0        # :211
NUM_SLOTS = 3              # the shipped net is a 4-agent net
TURNING_LIMIT = math.pi / 6.0   # nn_navigation_value_multi.py:52
# training_passing_side_weight (nn_navigation_value_multi.py:214)
PASSING_SIDE_WEIGHT = 0.5


def _close_actions_table():
    """The 25-row close-action grid (find_close_actions, :87-110):
    [0, 0] plus speeds {1, .75, .5, .25} x 6 angles in [-pi/6, pi/6]."""
    angles = np.linspace(-np.pi / 6.0, np.pi / 6.0, 6, endpoint=True)
    speeds = np.linspace(1.0, 0.0, 4, endpoint=False)
    ag, sg = np.meshgrid(angles, speeds)
    a = np.append([0.0], ag.flatten())
    s = np.append([0.0], sg.flatten())
    return np.stack([s, a], axis=-1)                              # [25, 2]


_TABLES = {
    "near_offsets": np.linspace(-np.pi / 3.0, np.pi / 3.0, 10),
    "near_scales": [1.0, 0.75, 0.50, 0.25],
    "desired_scales": [1.0, 0.80, 0.60, 0.40, 0.20],
    "default_scales": [1.0, 0.75],
    "close": _close_actions_table(),
    "turn_frac": [1.0, 0.66, 0.33, -0.33, -0.66, -1.0],
}


@functools.lru_cache(maxsize=None)
def _table(name, dtype, device):
    """A constant table of the candidate sets on the device, made once per
    (dtype, device); ``turn`` is ``turn_frac * TURNING_LIMIT`` in the
    dtype."""
    if name == "turn":
        return _table("turn_frac", dtype, device) * TURNING_LIMIT
    return torch.as_tensor(np.asarray(_TABLES[name]), dtype=dtype, device=device)


def _const(name, like):
    return _table(name, like.dtype, like.device)


def _mod_wrap(a):
    """(a + pi) % (2 pi) - pi, a floor-mod as ``jnp.remainder`` (the legacy
    stack's angle wrap, find_angle_diff)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _dot(a, b):
    """``sum(a * b, axis=-1)`` of ``[..., 2]`` vectors as the JAX package's
    reduction computes it, summing from 0.0: a -0.0 result becomes +0.0,
    which decides ``atan2`` of a zero vector (two coincident agents)."""
    return a[..., 0] * b[..., 0] + 0.0 + a[..., 1] * b[..., 1]


def _take(values, index):
    """``values[..., index[...], :]``: rows of ``[..., N, F]`` at the
    ``[..., M]`` indices, plus 0.0 (the JAX package's one-hot sums)."""
    idx = index[..., None].expand(*index.shape, values.shape[-1])
    return torch.gather(values, -2, idx) + 0.0


def _gcp(s10):
    """The getting-close penalty of an ego state (find_action_rewards)."""
    d = maths.norm2(s10[..., 0:2] - s10[..., 6:8])
    v = s10[..., 5]
    return torch.pow(GAMMA, d / DT_NORMAL) * (1.0 - torch.pow(GAMMA, -v / DT_NORMAL))


def _candidate_actions(s10):
    """The 47 candidate (speed, global heading) pairs (find_actions_theta,
    nn_navigation_value_multi.py:561-647): ``[..., 47]`` each."""
    pref = s10[..., 5:6]
    cur_speed = maths.sqrt_rn(s10[..., 2] * s10[..., 2] + s10[..., 3] * s10[..., 3])
    desired_angle = _mod_wrap(torch.atan2(s10[..., 7] - s10[..., 1], s10[..., 6] - s10[..., 0]))
    near_headings = _mod_wrap(s10[..., 4:5] + _const("near_offsets", s10))        # [..., 10]
    near_speed = pref * _const("near_scales", s10)                     # [..., 4]
    zero = torch.zeros_like(pref)
    speeds = torch.cat([cur_speed[..., None], pref * _const("desired_scales", s10),
                        zero, torch.repeat_interleave(near_speed, 10, dim=-1)], dim=-1)
    headings = torch.cat([_mod_wrap(s10[..., 4:5]),
                          desired_angle[..., None].expand(*pref.shape[:-1], 5), zero,
                          near_headings.repeat(*([1] * (s10.dim() - 1)), 4)], dim=-1)
    return speeds, headings


def _candidate_actions_rotate(s10):
    """The dynamically-constrained candidates of ``rotate_constr`` mode
    (find_actions_theta_dynConstr, :649-722, called with dt = 1.0): every
    block of the reference's data-dependent set in a fixed slot, in its
    vstack order [default 2, desired 5, close 25, turning 6], and a mask of
    the conditional rows.  Returns ``[..., 38]`` speeds, headings, valid."""
    pref = s10[..., 5:6]
    cur_heading = s10[..., 4:5]
    cur_speed = maths.sqrt_rn(s10[..., 2] * s10[..., 2] + s10[..., 3] * s10[..., 3])[..., None]
    desired_heading = torch.atan2(s10[..., 7:8] - s10[..., 1:2], s10[..., 6:7] - s10[..., 0:1])
    desired_on = torch.abs(_mod_wrap(desired_heading - cur_heading)) < TURNING_LIMIT
    default_heading = torch.atan2(s10[..., 3:4], s10[..., 2:3])
    default_on = ((torch.abs(_mod_wrap(default_heading - cur_heading)) < TURNING_LIMIT)
                  & (cur_speed > 0.05))
    close = _const("close", s10)
    turn = _const("turn", s10)
    lead = pref.shape[:-1]
    speeds = torch.cat([_const("default_scales", s10) * cur_speed,
                        _const("desired_scales", s10) * pref,
                        close[:, 0] * pref, torch.zeros(*lead, 6, dtype=s10.dtype,
                                                        device=s10.device)], dim=-1)
    headings = _mod_wrap(torch.cat([default_heading.expand(*lead, 2),
                                    desired_heading.expand(*lead, 5),
                                    close[:, 1] + cur_heading, turn + cur_heading], dim=-1))
    valid = torch.cat([default_on.expand(*lead, 2), desired_on.expand(*lead, 5),
                       torch.ones(*lead, 31, dtype=torch.bool, device=s10.device)], dim=-1)
    return speeds, headings, valid


def _update_states(s10, speed, heading, dt, mode: str = "no_constr"):
    """Propagate the ego state ``[..., 10]`` under each action ``[..., N]``
    for ``dt`` ``[...]`` -> ``[..., N, 10]`` (update_states, :1700-1794; the
    turning-dir slot is not updated, the encoder never reads it).  ``mode``
    selects the next-heading rule: ``no_constr`` takes the action heading,
    ``rotate_constr`` clips the change to pref_speed / 0.5 * dt."""
    c, s = torch.cos(heading), torch.sin(heading)
    dt = dt[..., None]
    if mode == "no_constr":
        heading_next = heading
    elif mode == "rotate_constr":
        limit = s10[..., 5:6] / 0.5 * dt
        heading_next = _mod_wrap(s10[..., 4:5] + torch.clamp(
            _mod_wrap(heading - s10[..., 4:5]), min=-limit, max=limit))
    else:
        raise ValueError(f"unknown CADRL mode {mode!r}")
    rest = s10[..., None, 5:10].expand(*heading.shape, 5)
    moved = torch.stack([s10[..., 0:1] + speed * c * dt, s10[..., 1:2] + speed * s * dt,
                         speed * c, speed * s, heading_next], dim=-1)
    return torch.cat([moved, rest], dim=-1)


def _update_states_others(others_s10, others_action, dt):
    """Propagate each other slot ``[..., 3, 10]`` by its filtered action
    ``[..., 3, 2]`` for ``dt`` ``[...]`` (update_state, :1636-1700)."""
    c, s = torch.cos(others_action[..., 1]), torch.sin(others_action[..., 1])
    speed = others_action[..., 0]
    dt = dt[..., None]
    return torch.cat([torch.stack([others_s10[..., 0] + speed * c * dt,
                                   others_s10[..., 1] + speed * s * dt,
                                   speed * c, speed * s, others_action[..., 1]], dim=-1),
                      others_s10[..., 5:10]], dim=-1)


def _seg_min_dists(x1, x2, y1, y2):
    """Min distance between the moving-point segments x1 -> x2 and y1 -> y2
    (``[..., 2]``, broadcast) (find_dist_between_segs,
    gen_rand_testcases.py:54-88; the start distance is not part of it)."""
    end_dist = maths.norm2(x2 - y2)
    z_bar = (x2 - x1) - (y2 - y1)
    zz = _dot(z_bar, z_bar)
    nonzero = maths.sqrt_rn(zz) > 0
    t_bar = -_dot(x1 - y1, z_bar) / torch.where(nonzero, zz, torch.ones_like(zz))
    t = t_bar[..., None]
    dist_bar = maths.norm2((x1 + (x2 - x1) * t) - (y1 + (y2 - y1) * t))
    use_crit = nonzero & (t_bar > 0) & (t_bar < 1.0)
    return torch.minimum(end_dist, torch.where(use_crit, dist_bar, end_dist))


def _if_actions_collide(s10, speed, heading, others_s10, others_action, dt):
    """``(min_dists, if_collide)`` ``[..., 3, N]`` of each candidate against
    each other slot (if_actions_collide, :1874-2007), with the front-agent
    velocity projection (:1913-1957)."""
    pref = s10[..., None, 5]                                              # [..., 1]
    other_speed = others_action[..., 0]                                   # [..., 3]
    radius = s10[..., None, 8] + others_s10[..., 8] + RADIUS_BUFFER       # [..., 3]
    p_e = s10[..., None, 0:2]                                             # [..., 1, 2]
    p_o = others_s10[..., 0:2]                                            # [..., 3, 2]
    dist_eo = maths.norm2(p_e - p_o)                                      # [..., 3]
    too_far = dist_eo > (pref + other_speed) * dt[..., None] + radius

    agent_vels = torch.stack([speed * torch.cos(heading), speed * torch.sin(heading)], dim=-1)
    other_v = torch.stack([others_action[..., 0] * torch.cos(others_action[..., 1]),
                           others_action[..., 0] * torch.sin(others_action[..., 1])], dim=-1)
    av = agent_vels[..., None, :, :]                                      # [..., 1, N, 2]
    ov = other_v[..., None, :].expand(*other_v.shape[:-1], speed.shape[-1], 2)  # [..., 3, N, 2]

    p_oa_angle = torch.atan2(p_o[..., 1] - p_e[..., 1], p_o[..., 0] - p_e[..., 0])
    agent_speed_angles = torch.atan2(agent_vels[..., 1], agent_vels[..., 0])[..., None, :]
    other_speed_angle = torch.atan2(other_v[..., 1], other_v[..., 0])
    heading_diff = _mod_wrap(agent_speed_angles - other_speed_angle[..., None])
    heading_2_other = _mod_wrap(agent_speed_angles - p_oa_angle[..., None])
    r_close = s10[..., None, 8] + others_s10[..., 8] + GETTING_CLOSE_RANGE
    coll_angle = torch.abs(torch.arcsin(torch.clamp(
        r_close / torch.clamp(dist_eo, min=1e-30), max=0.95)))
    front = ((torch.abs(heading_2_other) < coll_angle[..., None])
             & (torch.abs(heading_diff) < math.pi / 2.0))
    dot = _dot(av, ov)
    vel_norm = maths.norm2(av)
    # only rows with vx > EPS get normalised (reference quirk, :1946-1949)
    dot = torch.where(av[..., 0] > EPS, dot / torch.clamp(vel_norm, min=1e-30), dot)
    ov = torch.where(front[..., None], ov - dot[..., None] * av / 2.0, ov)

    horizon = torch.clamp(dt, max=1.0)[..., None, None, None]
    min_dists = _seg_min_dists(p_e[..., None, :], p_e[..., None, :] + horizon * av,
                               p_o[..., None, :], p_o[..., None, :] + horizon * ov)
    r = radius[..., None]
    if_collide = (dist_eo < radius)[..., None] | (min_dists < r)
    min_dists = min_dists - r
    min_dists = torch.where(too_far[..., None], r + GETTING_CLOSE_RANGE + EPS, min_dists)
    return min_dists, if_collide & ~too_far[..., None]


def _action_rewards(s10, cur_dist, min_dists):
    """Shaped per-action rewards (find_action_rewards, :776-827)."""
    gcp = _gcp(s10)[..., None]
    zero = torch.zeros_like(min_dists)
    rewards = torch.where((cur_dist < GETTING_CLOSE_RANGE)[..., None], gcp, zero)
    close = (min_dists > 0) & (min_dists < GETTING_CLOSE_RANGE)
    rewards = torch.where(close, rewards + gcp, rewards)
    rewards = torch.where(min_dists < 0, torch.full_like(zero, COLLISION_COST), rewards)
    shaped = 2.0 * rewards + 5.0 * gcp * (GETTING_CLOSE_RANGE - min_dists)
    rewards = torch.where(close, torch.clamp(shaped, COLLISION_COST + 0.01, 0.0), rewards)
    # a collision at the current position overrides everything (:783-785)
    return torch.where((cur_dist < 0)[..., None], torch.full_like(zero, COLLISION_COST), rewards)


def _encode(agent_next, others_next, others_present):
    """Agent-centric encoding of ego next-states ``[..., N, 10]`` against
    <= 3 other next-states ``[..., 3, 10]`` (closest first) ->
    ``[..., N, 31]`` (rawStates_2_agentCentricStates,
    pedData_processing_multi.py:375-471).  Absent slots (``others_present``
    ``[..., 3]`` False) repeat block 0's first 7 fields with is_on = 0."""
    goal_dir = agent_next[..., 6:8] - agent_next[..., 0:2]
    dist_to_goal = torch.clamp(maths.norm2(goal_dir), 0, 30)
    heading_n = agent_next[..., 4]
    ref_prll = torch.stack([torch.cos(heading_n), torch.sin(heading_n)], dim=-1)
    # division by the clipped distance (reference quirk: beyond 30 m the
    # frame axis is not unit length)
    ref_prll = torch.where((dist_to_goal > EPS)[..., None],
                           goal_dir / torch.clamp(dist_to_goal, min=1e-30)[..., None], ref_prll)
    ref_orth = torch.stack([-ref_prll[..., 1], ref_prll[..., 0]], dim=-1)
    heading = _mod_wrap(heading_n - torch.atan2(ref_prll[..., 1], ref_prll[..., 0]))
    cur_speed = maths.norm2(agent_next[..., 2:4])
    radius = agent_next[..., 8]
    cols = [dist_to_goal, agent_next[..., 5], cur_speed, heading,
            cur_speed * torch.cos(heading), cur_speed * torch.sin(heading), radius]

    blocks = []
    for i in range(NUM_SLOTS):
        o = others_next[..., i, None, :]                                  # [..., 1, 10]
        rel = o[..., 0:2] - agent_next[..., 0:2]
        ovx, ovy = _dot(o[..., 2:4], ref_prll), _dot(o[..., 2:4], ref_orth)
        o_r = o[..., 8].expand_as(radius)
        d2o = maths.norm2(agent_next[..., 0:2] - o[..., 0:2]) - radius - o_r
        is_on = torch.where(ovx * ovx + ovy * ovy < EPS, 2.0, 1.0).to(radius.dtype)
        blocks.append([ovx, ovy, torch.clamp(_dot(rel, ref_prll), -8, 8),
                       torch.clamp(_dot(rel, ref_orth), -8, 8), o_r, radius + o_r,
                       torch.clamp(d2o, -3, 10), is_on])
    zero = torch.zeros_like(radius)
    for i in range(NUM_SLOTS):
        on = others_present[..., i, None]
        for f in range(8):
            cols.append(torch.where(on, blocks[i][f], blocks[0][f] if f < 7 else zero))
    return torch.stack(cols, dim=-1)


def _find_bad_inds(states_nn, side: str):
    """Passing-side rule violations of an encoded batch ``[..., N, 31]`` ->
    ``[..., N]`` (find_bad_inds, nn_navigation_value_multi.py:2420-2573):
    the union of the oppo/same/tangent masks, which all carry the same
    penalty (:887-893)."""
    agent_vel = states_nn[..., 4:6]
    agent_speed = maths.norm2(agent_vel)
    agent_heading = states_nn[..., 3]
    dist_2_goal = states_nn[..., 0]
    other_px, other_py = states_nn[..., 9], states_nn[..., 10]
    other_vel = states_nn[..., 7:9]
    other_speed = maths.norm2(other_vel)
    other_heading = torch.atan2(other_vel[..., 1], other_vel[..., 0])
    rel_vel = agent_vel - other_vel
    rot_angle = _mod_wrap(torch.atan2(rel_vel[..., 1], rel_vel[..., 0])
                          - torch.atan2(-other_py, -other_px))

    base = (dist_2_goal > 1) & (other_speed > EPS) & (agent_speed > EPS)
    # reference quirk (:2494, :2556): the tangent test reads the scalar
    # states[0, 1] (row 0's pref_speed) of each agent's batch
    agent_speed_0 = states_nn[..., 0:1, 1]
    base_tangent = (dist_2_goal > 1) & (other_speed > EPS) & (agent_speed_0 > EPS)
    other_rel_dist = maths.sqrt_rn(other_px * other_px + other_py * other_py)
    calm = torch.abs(other_heading) < math.pi / 6.0
    crossing = torch.abs(other_heading) > math.pi / 4.0
    if side == "right":
        same_fast = base & (agent_speed > other_speed + 0.1) & (
            (other_py > -0.5) & (other_py < 2) & (other_px > 0) & (other_px < 3)
        ) & (agent_heading < 0) & calm
        same_slow = base & (agent_speed < other_speed - 0.1) & (
            (other_py < 0) & (other_py > -2) & (other_px < 0) & (other_px > -3)
        ) & (agent_heading > 0) & calm
        oppo = base & (
            (other_py < 0) & (other_py > -2) & (other_px > 0) & (other_px < 5)
        ) & (agent_heading > EPS) & (other_heading < -5.0 * math.pi / 6.0)
        tangent = base_tangent & (other_px > 0) & (other_rel_dist < 3) & (
            rot_angle < 0) & crossing & (agent_speed_0 > other_speed - 0.2)
    elif side == "left":
        same_fast = base & (agent_speed > other_speed + 0.1) & (
            (other_py > -2) & (other_py < 0.5) & (other_px > 0) & (other_px < 3)
        ) & (agent_heading > 0) & calm
        same_slow = base & (agent_speed < other_speed - 0.1) & (
            (other_py < 2) & (other_py > 0) & (other_px < 0) & (other_px > -3)
        ) & (agent_heading > 0) & calm
        oppo = base & (
            (other_py < 2) & (other_py > 0) & (other_px > 0) & (other_px < 5)
        ) & (agent_heading < EPS) & (other_heading > 5.0 * math.pi / 6.0)
        tangent = base_tangent & (other_px > 0) & (other_rel_dist < 3) & (
            rot_angle > 0) & crossing & (agent_speed_0 > other_speed - 0.2)
    else:
        raise ValueError(f"passing side must be 'right' or 'left', got {side!r}")
    return same_fast | same_slow | oppo | tangent


def _passing_side_cost(s10, agent_next, others_s10, others_next, present, side: str):
    """Social-norm penalty ``[..., N]`` added to the action rewards
    (find_passing_side_cost, nn_navigation_value_multi.py:829-894): encode
    the propagated ego states against the closest propagated other and
    charge ``weight * getting_close_penalty`` on rule-violating actions."""
    # closest other by current clearance, no buffer (:846-856)
    d2o = torch.where(present, maths.norm2(others_s10[..., 0:2] - s10[..., None, 0:2])
                      - others_s10[..., 8] - s10[..., None, 8],
                      torch.full_like(others_s10[..., 8], math.inf))
    other_next = _take(others_next, torch.argmin(d2o, dim=-1)[..., None])   # [..., 1, 10]
    # encoded against a single other in slot 0 (:862-868)
    present_one = torch.zeros_like(present)
    present_one[..., 0] = True
    states_nn = _encode(agent_next, other_next.expand_as(others_next), present_one)
    bad = _find_bad_inds(states_nn, side)
    return torch.where(bad, PASSING_SIDE_WEIGHT * _gcp(s10)[..., None],
                       torch.zeros((), dtype=s10.dtype, device=s10.device))


def _ego_s10(state):
    """``[E, A, 10]``: pos, vel, heading, pref_speed, goal, radius,
    turning_dir of every agent."""
    return torch.cat([state.pos, state.vel, state.heading[..., None],
                      state.pref_speed[..., None], state.goal, state.radius[..., None],
                      state.turning_dir[..., None]], dim=-1)


def _select_others(state, cfg):
    """The wrapper's <= 3 closest others of every ego agent
    (CADRLPolicy.py:125-139): candidates ascending by (-round(d, 2), p_orth)
    and the last min(3, K) taken, so the closest, the farthest of them in
    slot 0.  The rank is the JAX package's pairwise lexicographic rank; the
    rows are gathered.

    Returns:
        (others_s10 ``[E, A, 3, 10]``, others_action ``[E, A, 3, 2]`` the
        filtered past velocities as (speed, angle), present ``[E, A, 3]``,
        num_present ``[E, A]``); absent slots are zero.
    """
    E, A = state.pos.shape[:2]
    device = state.pos.device
    rel = state.pos[:, None, :, :] - state.pos[:, :, None, :]             # [E, h, j, 2]
    dist_centers = maths.norm2(rel)
    d2other = dist_centers - state.radius[..., None] - state.radius[:, None, :]
    p_orth = (rel[..., 0] * state.ref_orth[..., 0, None]
              + rel[..., 1] * state.ref_orth[..., 1, None])
    idx = torch.arange(A, device=device)
    cand = ((idx[:, None] != idx[None, :]) & state.valid[:, None, :]
            & (dist_centers <= cfg.sensing_horizon))
    neg_inf = torch.full_like(d2other, -math.inf)
    key1 = torch.where(cand, -(torch.round(d2other * 100.0)
                               * reciprocal(100.0, d2other.dtype)), neg_inf)
    key2 = torch.where(cand, p_orth, neg_inf)
    rank = _lex_rank((key1, key2), idx)                                   # [E, h, j]
    k_slots = min(NUM_SLOTS, cfg.max_num_other_agents_observed)
    eligible = cand & (rank >= A - k_slots)
    num_present = torch.sum(eligible, dim=-1)                             # [E, h]
    slot_of = rank - (A - num_present[..., None])
    slots = torch.arange(NUM_SLOTS, device=device)
    onehot = eligible[..., None, :] & (slot_of[..., None, :] == slots[:, None])  # [E, h, 3, j]
    source = torch.sum(onehot.long() * idx, dim=-1)                       # [E, h, 3]
    present = slots < num_present[..., None]

    fields = _ego_s10(state)
    others_s10 = _take(fields[:, None].expand(E, A, A, 10), source)
    past = state.past_vel.flatten(2)                                      # [E, j, K * 2]
    past_sel = _take(past[:, None].expand(E, A, A, past.shape[-1]), source)
    zero = torch.zeros((), dtype=fields.dtype, device=device)
    others_s10 = torch.where(present[..., None], others_s10, zero)
    past_sel = torch.where(present[..., None], past_sel, zero)
    others_action = maths.filter_vel(
        cfg.dt, past_sel.reshape(E, A, NUM_SLOTS, *state.past_vel.shape[-2:]))
    return others_s10, others_action, present, num_present


def _swap_slot0(rows, present, closest):
    """Swap slot 0 with slot ``closest`` ``[...]`` (the encoder's
    closest-other reorder, pedData_processing_multi.py:268-277)."""
    slots = torch.arange(NUM_SLOTS, device=rows.device)
    c = closest[..., None]
    perm = torch.where(slots == 0, c, torch.where(slots == c, torch.zeros_like(c), slots))
    return _take(rows, perm), torch.gather(present, -1, perm)


def _takes_kernel(device, cfg) -> bool:
    """Whether ``_cadrl_prepare`` runs the lookahead as one launch of
    ``csrc/cadrl_lookahead.cu``: on a CUDA device in ``no_constr`` mode with
    no passing side (cadrl4's configuration and the ``EnvConfig``
    default).  The CPU, ``rotate_constr`` and the passing sides take
    :func:`_lookahead_plain`, the version the kernel is held to."""
    return (device.type == "cuda" and cfg.cadrl_mode == "no_constr"
            and cfg.cadrl_passing_side == "none")


def _cadrl_prepare(state, cfg):
    """Everything before the value net, for every ego agent: other
    selection, candidates, collision pruning, rewards, propagation and the
    agent-centric encoding.  Returns ``(states_nn [E, A, N, 31], aux)`` with
    N = 47 (38 in ``rotate_constr`` mode) and the JAX package's aux fields
    with ``[E, A]`` in front."""
    s10 = _ego_s10(state)
    others_s10, others_action, present, num_present = _select_others(state, cfg)
    if _takes_kernel(s10.device, cfg):
        states_nn, aux = cadrl_lookahead.lookahead_cuda(s10, others_s10, others_action, present)
    else:
        states_nn, aux = _lookahead_plain(s10, others_s10, others_action, present, cfg)
    aux.update(pref=s10[..., 5], heading_h=state.heading,
               heading_ego_h=state.heading_ego_frame, num_present=num_present)
    return states_nn, aux


def _lookahead_plain(s10, others_s10, others_action, present, cfg):
    """The lookahead of ``_cadrl_prepare`` after the other selection, in
    plain PyTorch: ``(states_nn [E, A, N, 31], aux)`` with the aux fields
    of the candidates and ``dt_forward``."""
    # the others' velocity from their filtered action (:974-983)
    others_s10 = torch.cat([others_s10[..., 0:2],
                            (others_action[..., 0] * torch.cos(others_action[..., 1]))[..., None],
                            (others_action[..., 0] * torch.sin(others_action[..., 1]))[..., None],
                            others_s10[..., 4:]], dim=-1)

    # lookahead horizon (:1258-1265)
    pref = s10[..., 5]
    dist_to_goal = maths.norm2(s10[..., 6:8] - s10[..., 0:2])
    dt_forward = torch.minimum(torch.clamp(torch.full_like(pref, 0.5) / pref,
                                           min=DT_FORWARD_DEFAULT), dist_to_goal / pref)

    if cfg.cadrl_mode == "rotate_constr":
        a_speed, a_heading, action_valid = _candidate_actions_rotate(s10)
    else:
        a_speed, a_heading = _candidate_actions(s10)
        action_valid = torch.ones_like(a_speed, dtype=torch.bool)

    # collisions against each present other (:1005-1017)
    min_d, if_c = _if_actions_collide(s10, a_speed, a_heading, others_s10, others_action,
                                      dt_forward)
    p = present[..., None]
    min_dists = torch.where(p, min_d, torch.full_like(min_d, math.inf)).amin(dim=-2)
    if_collide = (p & if_c).any(dim=-2)
    cur_dist = torch.where(present, maths.norm2(s10[..., None, 0:2] - others_s10[..., 0:2])
                           - (s10[..., None, 8] + others_s10[..., 8] + RADIUS_BUFFER),
                           torch.full_like(others_s10[..., 8], math.inf)).amin(dim=-1)
    action_rewards = _action_rewards(s10, cur_dist, min_dists)

    # propagate the ego and the others one lookahead step
    agent_next = _update_states(s10, a_speed, a_heading, dt_forward, cfg.cadrl_mode)
    others_next = _update_states_others(others_s10, others_action, dt_forward)
    # social-norm penalty (:1188-1223), identically zero for side 'none'
    if cfg.cadrl_passing_side != "none":
        action_rewards = action_rewards + _passing_side_cost(
            s10, agent_next, others_s10, others_next, present, cfg.cadrl_passing_side)

    d_next = maths.norm2(agent_next[..., 0:2] - agent_next[..., 6:8])
    reached = (d_next < DIST_2_GOAL_THRES) & (min_dists > GETTING_CLOSE_RANGE)
    needs_nn = ~if_collide & ~reached

    # encoder reorder: the closest other to slot 0, measured from the first
    # NN-queried row's next position (pedData_processing_multi.py:268-277)
    first_sel = torch.argmax((needs_nn & action_valid).to(torch.int32), dim=-1)   # 0 if none
    first_pos = _take(agent_next[..., 0:2], first_sel[..., None])                # [E, A, 1, 2]
    d_reorder = torch.where(present, maths.norm2(others_next[..., 0:2] - first_pos),
                            torch.full_like(others_next[..., 0], math.inf))
    others_next_r, present_r = _swap_slot0(others_next, present, torch.argmin(d_reorder, dim=-1))

    states_nn = _encode(agent_next, others_next_r, present_r)
    aux = {
        "action_speed": a_speed,
        "action_heading": a_heading,
        "action_valid": action_valid,
        "action_rewards": action_rewards,
        "if_collide": if_collide,
        "reached": reached,
        "d_next": d_next,
        "dist_col": states_nn[..., 0],
        "dt_forward": dt_forward,
    }
    return states_nn, aux


def _cadrl_values(aux, nn_raw):
    """Reward plus discounted bounded value of every candidate
    ``[E, A, N]`` (:1284-1295, 2052-2100); rows missing from the
    reference's dynamic action set are -inf."""
    nn_vals = torch.clamp(nn_raw, -0.25, 1.0)
    nn_vals = torch.minimum(torch.pow(GAMMA, aux["dist_col"] / DT_NORMAL), nn_vals)
    state_values = torch.where(
        aux["if_collide"], torch.zeros_like(nn_vals),
        torch.where(aux["reached"], torch.pow(GAMMA, aux["d_next"] / DT_NORMAL), nn_vals))
    dtf, pref = aux["dt_forward"][..., None], aux["pref"][..., None]
    dt_vec = 0.2 * dtf + 0.8 * aux["action_speed"] / pref * dtf
    values = aux["action_rewards"] + torch.pow(GAMMA, dt_vec * pref / DT_NORMAL) * state_values
    return torch.where(aux["action_valid"], values, torch.full_like(values, -math.inf))


def _cadrl_finish(aux, nn_raw):
    """The argmax action of every agent ``[E, A, 2]`` (CADRLPolicy.py:71-81):
    the heading becomes an offset from the current heading; with no
    visible other, straight to the goal at speed 1.0 (the reference's
    intent at CADRLPolicy.py:80)."""
    best = torch.argmax(_cadrl_values(aux, nn_raw), dim=-1)[..., None]
    speed = torch.gather(aux["action_speed"], -1, best)[..., 0] + 0.0
    heading = torch.gather(aux["action_heading"], -1, best)[..., 0] + 0.0
    action = torch.stack([speed, maths.wrap(heading - aux["heading_h"])], dim=-1)
    fallback = torch.stack([torch.ones_like(speed), -aux["heading_ego_h"]], dim=-1)
    return torch.where((aux["num_present"] > 0)[..., None], action, fallback)


def _net(params):
    if params is None or PARAMS_KEY not in params:
        raise ValueError("CADRL policy requires params['cadrl'] "
                         "(models.cadrl.load_params())")
    return params[PARAMS_KEY]


def cadrl_values(states, cfg, params):
    """``(values [E, A, N], aux)``: every candidate's value and the
    prepare step's fields, the value net run once on ``[E, A, N, 31]``."""
    states_nn, aux = _cadrl_prepare(states, cfg)
    return _cadrl_values(aux, cadrl_net.forward_raw(_net(params), states_nn)), aux


def cadrl_kernel(states, cfg, params):
    """``[E, A, 2]`` (speed, delta heading) of SA-CADRL for every agent."""
    states_nn, aux = _cadrl_prepare(states, cfg)
    return _cadrl_finish(aux, cadrl_net.forward_raw(_net(params), states_nn))


def cadrl_state_values(states, cfg, params):
    """``[E, A]`` CADRL value of every agent's current state
    (find_next_action_and_value -> find_states_values, CADRLPolicy.py:43-48,
    nn_navigation_value_multi.py:2052-2071): the current state encoded
    against its <= 3 others (closest in slot 0), with the [-0.25, 1] clip
    and the gamma bound.  ``params`` is the dict or the net itself."""
    net = params[PARAMS_KEY] if isinstance(params, dict) else params
    s10 = _ego_s10(states)
    others_s10, _action, present, _n = _select_others(states, cfg)
    d_reorder = torch.where(present, maths.norm2(others_s10[..., 0:2] - s10[..., None, 0:2]),
                            torch.full_like(others_s10[..., 0], math.inf))
    others_r, present_r = _swap_slot0(others_s10, present, torch.argmin(d_reorder, dim=-1))
    state_nn = _encode(s10[..., None, :], others_r, present_r)[..., 0, :]
    val = torch.clamp(cadrl_net.forward_raw(net, state_nn), -0.25, 1.0)
    return torch.minimum(torch.pow(GAMMA, state_nn[..., 0] / DT_NORMAL), val)
