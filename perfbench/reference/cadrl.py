"""Plain reference of the SA-CADRL policy (Chen et al., IROS 2017,
arXiv:1703.08862; upstream ``envs/policies/CADRLPolicy.py:27-167`` over the
legacy ``nn_navigation_value_multi.py`` stack), read from the shipped
``no_constr`` value net: a frozen copy of the port's plain lookahead in its
``no_constr`` mode with passing side ``none``, on dict states.

Each ego agent picks its <= 3 closest others, builds 47 candidate (speed,
heading) actions, propagates itself and the others one lookahead step,
prunes colliding candidates, adds shaped rewards, encodes every propagated
state in its agent-centric frame, runs the value net
(31 -> 200 -> 200 -> block max -> 100 -> 50 -> 1) on all of them and takes
the argmax of reward plus discounted value.  Constants from
CADRL/scripts/multi/global_var.py:5-62.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from perfbench.reference.sim import lex_rank, norm2, sqrt_rn, wrap

GAMMA = 0.97
DT_NORMAL = 0.5
COLLISION_COST = -0.25
DIST_2_GOAL_THRES = 0.05
GETTING_CLOSE_RANGE = 0.2
EPS = 1e-5
DT_FORWARD_DEFAULT = 1.0
RADIUS_BUFFER = 0.0
NUM_SLOTS = 3
NUM_CANDIDATES = 47
LAYERS = ((31, 200), (200, 200), (100, 50), (50, 1))
NAMES = ("W0", "b0", "W1", "b1", "W3", "b3", "W4", "b4", "avg_vec", "std_vec", "output_avg",
         "output_std")


_TABLES = {
    "near_offsets": np.linspace(-np.pi / 3.0, np.pi / 3.0, 10),
    "near_scales": [1.0, 0.75, 0.50, 0.25],
    "desired_scales": [1.0, 0.80, 0.60, 0.40, 0.20],
}


@functools.lru_cache(maxsize=None)
def _table(name, dtype, device):
    return torch.as_tensor(np.asarray(_TABLES[name]), dtype=dtype, device=device)


def _const(name, like):
    return _table(name, like.dtype, like.device)


def _reciprocal(value, dtype):
    """``1 / value`` rounded to ``dtype``, as a Python float."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return float(np_dtype(1.0) / np_dtype(value))


def _filter_vel(dt, past_vel_xy):
    """dt-weighted mean of past velocities -> (speed, angle) (envs/util.py:124-131),
    summed from 0 in order, the quotient a product with the rounded reciprocal."""
    np_dtype = np.float32 if past_vel_xy.dtype == torch.float32 else np.float64
    w = np_dtype(dt)
    denom = np_dtype(0.0)
    total = torch.zeros_like(past_vel_xy[..., 0, :])
    for k in range(past_vel_xy.shape[-2]):
        denom = denom + w
        total = total + float(w) * past_vel_xy[..., k, :]
    avg = total * float(np_dtype(1.0) / denom)
    return torch.stack([norm2(avg), torch.atan2(avg[..., 1], avg[..., 0])], dim=-1)


def _ego_s10(s):
    """``[E, A, 10]``: pos, vel, heading, pref_speed, goal, radius, turning_dir."""
    return torch.cat([s["pos"], s["vel"], s["heading"][..., None], s["pref_speed"][..., None],
                      s["goal"], s["radius"][..., None], s["turning_dir"][..., None]], dim=-1)


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
    d = norm2(s10[..., 0:2] - s10[..., 6:8])
    v = s10[..., 5]
    return torch.pow(GAMMA, d / DT_NORMAL) * (1.0 - torch.pow(GAMMA, -v / DT_NORMAL))


def _candidate_actions(s10):
    """The 47 candidate (speed, global heading) pairs (find_actions_theta,
    nn_navigation_value_multi.py:561-647): ``[..., 47]`` each."""
    pref = s10[..., 5:6]
    cur_speed = sqrt_rn(s10[..., 2] * s10[..., 2] + s10[..., 3] * s10[..., 3])
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


def _update_states(s10, speed, heading, dt):
    """Propagate the ego state ``[..., 10]`` under each action ``[..., N]``
    for ``dt`` ``[...]`` -> ``[..., N, 10]`` (update_states, :1700-1794,
    ``no_constr``: the next heading is the action's; the turning-dir slot is
    not updated, the encoder never reads it)."""
    c, s = torch.cos(heading), torch.sin(heading)
    dt = dt[..., None]
    rest = s10[..., None, 5:10].expand(*heading.shape, 5)
    moved = torch.stack([s10[..., 0:1] + speed * c * dt, s10[..., 1:2] + speed * s * dt,
                         speed * c, speed * s, heading], dim=-1)
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
    end_dist = norm2(x2 - y2)
    z_bar = (x2 - x1) - (y2 - y1)
    zz = _dot(z_bar, z_bar)
    nonzero = sqrt_rn(zz) > 0
    t_bar = -_dot(x1 - y1, z_bar) / torch.where(nonzero, zz, torch.ones_like(zz))
    t = t_bar[..., None]
    dist_bar = norm2((x1 + (x2 - x1) * t) - (y1 + (y2 - y1) * t))
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
    dist_eo = norm2(p_e - p_o)                                      # [..., 3]
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
    vel_norm = norm2(av)
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
    dist_to_goal = torch.clamp(norm2(goal_dir), 0, 30)
    heading_n = agent_next[..., 4]
    ref_prll = torch.stack([torch.cos(heading_n), torch.sin(heading_n)], dim=-1)
    # division by the clipped distance (reference quirk: beyond 30 m the
    # frame axis is not unit length)
    ref_prll = torch.where((dist_to_goal > EPS)[..., None],
                           goal_dir / torch.clamp(dist_to_goal, min=1e-30)[..., None], ref_prll)
    ref_orth = torch.stack([-ref_prll[..., 1], ref_prll[..., 0]], dim=-1)
    heading = _mod_wrap(heading_n - torch.atan2(ref_prll[..., 1], ref_prll[..., 0]))
    cur_speed = norm2(agent_next[..., 2:4])
    radius = agent_next[..., 8]
    cols = [dist_to_goal, agent_next[..., 5], cur_speed, heading,
            cur_speed * torch.cos(heading), cur_speed * torch.sin(heading), radius]

    blocks = []
    for i in range(NUM_SLOTS):
        o = others_next[..., i, None, :]                                  # [..., 1, 10]
        rel = o[..., 0:2] - agent_next[..., 0:2]
        ovx, ovy = _dot(o[..., 2:4], ref_prll), _dot(o[..., 2:4], ref_orth)
        o_r = o[..., 8].expand_as(radius)
        d2o = norm2(agent_next[..., 0:2] - o[..., 0:2]) - radius - o_r
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


def _select_others(s, cfg):
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
    E, A = s["pos"].shape[:2]
    device = s["pos"].device
    rel = s["pos"][:, None, :, :] - s["pos"][:, :, None, :]             # [E, h, j, 2]
    dist_centers = norm2(rel)
    d2other = dist_centers - s["radius"][..., None] - s["radius"][:, None, :]
    p_orth = (rel[..., 0] * s["ref_orth"][..., 0, None]
              + rel[..., 1] * s["ref_orth"][..., 1, None])
    idx = torch.arange(A, device=device)
    cand = ((idx[:, None] != idx[None, :]) & s["valid"][:, None, :]
            & (dist_centers <= cfg.sensing_horizon))
    neg_inf = torch.full_like(d2other, -math.inf)
    key1 = torch.where(cand, -(torch.round(d2other * 100.0)
                               * _reciprocal(100.0, d2other.dtype)), neg_inf)
    key2 = torch.where(cand, p_orth, neg_inf)
    rank = lex_rank((key1, key2), idx, None)                                   # [E, h, j]
    k_slots = min(NUM_SLOTS, cfg.max_num_other_agents_observed)
    eligible = cand & (rank >= A - k_slots)
    num_present = torch.sum(eligible, dim=-1)                             # [E, h]
    slot_of = rank - (A - num_present[..., None])
    slots = torch.arange(NUM_SLOTS, device=device)
    onehot = eligible[..., None, :] & (slot_of[..., None, :] == slots[:, None])  # [E, h, 3, j]
    source = torch.sum(onehot.long() * idx, dim=-1)                       # [E, h, 3]
    present = slots < num_present[..., None]

    fields = _ego_s10(s)
    others_s10 = _take(fields[:, None].expand(E, A, A, 10), source)
    past = s["past_vel"].flatten(2)                                      # [E, j, K * 2]
    past_sel = _take(past[:, None].expand(E, A, A, past.shape[-1]), source)
    zero = torch.zeros((), dtype=fields.dtype, device=device)
    others_s10 = torch.where(present[..., None], others_s10, zero)
    past_sel = torch.where(present[..., None], past_sel, zero)
    others_action = _filter_vel(
        cfg.dt, past_sel.reshape(E, A, NUM_SLOTS, *s["past_vel"].shape[-2:]))
    return others_s10, others_action, present, num_present


def _swap_slot0(rows, present, closest):
    """Swap slot 0 with slot ``closest`` ``[...]`` (the encoder's
    closest-other reorder, pedData_processing_multi.py:268-277)."""
    slots = torch.arange(NUM_SLOTS, device=rows.device)
    c = closest[..., None]
    perm = torch.where(slots == 0, c, torch.where(slots == c, torch.zeros_like(c), slots))
    return _take(rows, perm), torch.gather(present, -1, perm)


def _cadrl_prepare(s, cfg):
    """Everything before the value net, for every ego agent: other
    selection, candidates, collision pruning, rewards, propagation and the
    agent-centric encoding.  Returns ``(states_nn [E, A, N, 31], aux)`` with
    N = 47 and the aux fields with ``[E, A]`` in front."""
    s10 = _ego_s10(s)
    others_s10, others_action, present, num_present = _select_others(s, cfg)
    # the others' velocity from their filtered action (:974-983)
    others_s10 = torch.cat([others_s10[..., 0:2],
                            (others_action[..., 0] * torch.cos(others_action[..., 1]))[..., None],
                            (others_action[..., 0] * torch.sin(others_action[..., 1]))[..., None],
                            others_s10[..., 4:]], dim=-1)

    # lookahead horizon (:1258-1265)
    pref = s10[..., 5]
    dist_to_goal = norm2(s10[..., 6:8] - s10[..., 0:2])
    dt_forward = torch.minimum(torch.clamp(torch.full_like(pref, 0.5) / pref,
                                           min=DT_FORWARD_DEFAULT), dist_to_goal / pref)

    a_speed, a_heading = _candidate_actions(s10)
    action_valid = torch.ones_like(a_speed, dtype=torch.bool)

    # collisions against each present other (:1005-1017)
    min_d, if_c = _if_actions_collide(s10, a_speed, a_heading, others_s10, others_action,
                                      dt_forward)
    p = present[..., None]
    min_dists = torch.where(p, min_d, torch.full_like(min_d, math.inf)).amin(dim=-2)
    if_collide = (p & if_c).any(dim=-2)
    cur_dist = torch.where(present, norm2(s10[..., None, 0:2] - others_s10[..., 0:2])
                           - (s10[..., None, 8] + others_s10[..., 8] + RADIUS_BUFFER),
                           torch.full_like(others_s10[..., 8], math.inf)).amin(dim=-1)
    action_rewards = _action_rewards(s10, cur_dist, min_dists)

    # propagate the ego and the others one lookahead step
    agent_next = _update_states(s10, a_speed, a_heading, dt_forward)
    others_next = _update_states_others(others_s10, others_action, dt_forward)
    # (the social-norm penalty of :1188-1223 is zero for passing side 'none')

    d_next = norm2(agent_next[..., 0:2] - agent_next[..., 6:8])
    reached = (d_next < DIST_2_GOAL_THRES) & (min_dists > GETTING_CLOSE_RANGE)
    needs_nn = ~if_collide & ~reached

    # encoder reorder: the closest other to slot 0, measured from the first
    # NN-queried row's next position (pedData_processing_multi.py:268-277)
    first_sel = torch.argmax((needs_nn & action_valid).to(torch.int32), dim=-1)   # 0 if none
    first_pos = _take(agent_next[..., 0:2], first_sel[..., None])                # [E, A, 1, 2]
    d_reorder = torch.where(present, norm2(others_next[..., 0:2] - first_pos),
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
        "pref": pref,
        "heading_h": s["heading"],
        "heading_ego_h": s["heading_ego_frame"],
        "num_present": num_present,
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
    action = torch.stack([speed, wrap(heading - aux["heading_h"])], dim=-1)
    fallback = torch.stack([torch.ones_like(speed), -aux["heading_ego_h"]], dim=-1)
    return torch.where((aux["num_present"] > 0)[..., None], action, fallback)



def load(path: str, device) -> dict:
    with np.load(path) as z:
        w = {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device) for k in NAMES}
    w["inv_std"] = torch.as_tensor(np.float32(1.0) / np.asarray(w["std_vec"].cpu().numpy(),
                                                                 np.float32), device=device)
    return w


def flops(rows: int, num_agents: int) -> float:
    """The value net over the 47 candidates of ``rows`` agents (a
    multiply-add two operations): 31 -> 200 -> 200 -> block max -> 100 ->
    50 -> 1.  The lookahead's geometry is left out."""
    del num_agents
    return 2.0 * rows * NUM_CANDIDATES * sum(a * b for a, b in LAYERS)


def output_error(program, reference):
    """The raw candidate values' error, relative."""
    return (program - reference).abs() / (1.0 + reference.abs())


def value_net(w: dict, x):
    """Raw value of ``[..., 31]`` agent-centric states
    (neural_network_regr_multi.make_prediction_raw, :726-820)."""
    xn = (x - w["avg_vec"]) * w["inv_std"]
    h = torch.relu(torch.matmul(xn, w["W0"]) + w["b0"])
    h = torch.relu(torch.matmul(h, w["W1"]) + w["b1"])
    pooled = torch.maximum(torch.maximum(h[..., 50:100], h[..., 100:150]), h[..., 150:200])
    z = torch.relu(torch.matmul(torch.cat([h[..., :50], pooled], dim=-1), w["W3"]) + w["b3"])
    y = torch.matmul(z, w["W4"]) + w["b4"]
    return (y * w["output_std"] + w["output_avg"])[..., 0]


def decide(w: dict, s: dict, cfg, envs_per_block: int = 1024):
    """``(actions [E, A, 2], scores [E, A, 47], raw [E, A, 47], ranked
    [E, A])``: every agent's action, the candidate values its argmax ranks,
    the value net's raw outputs, and whether the argmax chose the action
    (not the no-other-visible fallback).  ``envs_per_block`` envs at a time,
    so that the lookahead's ``[E, A, 47, ...]`` intermediates stay small."""
    E = s["pos"].shape[0]
    outs = []
    for e0 in range(0, E, envs_per_block):
        sb = {k: v[e0:e0 + envs_per_block] for k, v in s.items()}
        states_nn, aux = _cadrl_prepare(sb, cfg)
        raw = value_net(w, states_nn)
        outs.append((_cadrl_finish(aux, raw), _cadrl_values(aux, raw), raw,
                     aux["num_present"] > 0))
    return tuple(torch.cat(parts) for parts in zip(*outs))
