"""Batched ORCA (reciprocal velocity obstacles), port of
:mod:`gym_collision_avoidance_tpu.ops.orca`.

The ORCA velocity of van den Berg et al. (ISRR 2009), as the reference's
RVO2 library computes it: a half-plane per neighbour, the incremental 2-D
linear program (LP2 with LP1 per inserted line, first failure latched) and
the densest-case fallback LP3.  Every quantity carries the batch axes in
front: agents ``[E, A]``, neighbour lines ``[E, A, NL, 2]`` with
``NL = A - 1``; Python loops run over the line index only.

As in the JAX package the lines are built for every (agent, other) pair in
natural order and then put in rank order, the stable order of (squared
distance, index) among the candidates; here by a stable sort and a gather
instead of the TPU's pairwise ranks and one-hot sums.  The LP loops over a
prefix of lines slice it instead of masking the rest, which leaves every
result unchanged (the masked rows never entered a result) and skips the
work.  Matches the JAX package to ~1e-12 in float64.  Every square root is
``maths.sqrt_rn``: with it the card's velocities equal the CPU's bitwise
(the rest is ``+ - * /`` and compares, IEEE on both devices).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gym_collision_avoidance_torch.core.maths import sqrt_rn
from gym_collision_avoidance_torch.maps.grid import reciprocal

EPS = 1e-5  # RVO_EPSILON


def _det(ax, ay, bx, by):
    return ax * by - ay * bx


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _cross_rows(d, p, lines_d, lines_p):
    """``_det(D, P - p_j)`` of one line ``(p, d)`` (``[..., 2]``) against
    each row of ``lines`` (``[..., n, 2]``): the two quantities LP1 and
    LP3 project with."""
    denom = _det(d[..., None, 0], d[..., None, 1], lines_d[..., 0], lines_d[..., 1])
    numer = _det(lines_d[..., 0], lines_d[..., 1],
                 p[..., None, 0] - lines_p[..., 0], p[..., None, 1] - lines_p[..., 1])
    return denom, numer


def _lp1(pt, dr, lvalid, k, radius, opt_vel, direction_opt):
    """Optimum on line ``k`` subject to lines ``j < k`` and the speed disc
    (linearProgram1).  ``pt``/``dr`` ``[..., NL, 2]``, ``lvalid``
    ``[..., NL]``, ``radius`` ``[...]``, ``opt_vel`` ``[..., 2]``.

    Returns (fail ``[...]``, result ``[..., 2]``).
    """
    p_k, d_k = pt[..., k, :], dr[..., k, :]
    dot_p = _dot2(p_k, d_k)
    disc = dot_p * dot_p + radius * radius - _dot2(p_k, p_k)
    fail = disc < 0.0
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    t_left = -dot_p - sq
    t_right = -dot_p + sq
    if k > 0:
        mask = lvalid[..., :k]
        denom, numer = _cross_rows(d_k, p_k, dr[..., :k, :], pt[..., :k, :])
        small = torch.abs(denom) <= EPS
        fail = fail | (mask & small & (numer < 0.0)).any(dim=-1)
        t = numer / torch.where(small, torch.ones_like(denom), denom)
        use = mask & ~small
        inf = torch.full_like(t, math.inf)
        t_right = torch.minimum(
            t_right, torch.where(use & (denom >= 0.0), t, inf).amin(dim=-1))
        t_left = torch.maximum(
            t_left, torch.where(use & (denom < 0.0), t, -inf).amax(dim=-1))
    fail = fail | (t_left > t_right)

    if direction_opt:
        t_sel = torch.where(_dot2(opt_vel, d_k) > 0.0, t_right, t_left)
    else:
        t_sel = torch.minimum(torch.maximum(_dot2(d_k, opt_vel - p_k), t_left), t_right)
    return fail, p_k + t_sel[..., None] * d_k


def _lp2(pt, dr, lvalid, radius, opt_vel, direction_opt):
    """Sequential constraint insertion (linearProgram2).

    Returns (result ``[..., 2]``, fail_idx ``[...]`` int64), fail_idx equal
    to the line count on success.
    """
    NL = pt.shape[-2]
    if direction_opt:
        result = radius[..., None] * opt_vel
    else:
        speed_sq = _dot2(opt_vel, opt_vel)
        # the 1e-300 guard is 0 in float32, as in the JAX package
        scaled = radius[..., None] * opt_vel / sqrt_rn(
            torch.clamp(speed_sq, min=1e-300))[..., None]
        result = torch.where((speed_sq > radius * radius)[..., None], scaled, opt_vel)

    fail_idx = torch.full(radius.shape, NL, dtype=torch.int64, device=radius.device)
    for k in range(NL):
        p_k, d_k = pt[..., k, :], dr[..., k, :]
        violated = _det(d_k[..., 0], d_k[..., 1],
                        p_k[..., 0] - result[..., 0], p_k[..., 1] - result[..., 1]) > 0.0
        active = lvalid[..., k] & (fail_idx == NL) & violated
        fail, res = _lp1(pt, dr, lvalid, k, radius, opt_vel, direction_opt)
        result = torch.where((active & ~fail)[..., None], res, result)
        fail_idx = torch.where(active & fail, torch.full_like(fail_idx, k), fail_idx)
    return result, fail_idx


def _lp3(pt, dr, lvalid, begin_line, radius, result):
    """Densest-case fallback (linearProgram3): the velocity that least
    violates the lines from ``begin_line`` on."""
    NL = pt.shape[-2]
    distance = torch.zeros_like(radius)
    for i in range(NL):
        p_i, d_i = pt[..., i, :], dr[..., i, :]
        viol = _det(d_i[..., 0], d_i[..., 1],
                    p_i[..., 0] - result[..., 0], p_i[..., 1] - result[..., 1])
        active = lvalid[..., i] & (i >= begin_line) & (viol > distance)

        # lines j < i projected onto line i
        pj, dj = pt[..., :i, :], dr[..., :i, :]
        denom, numer = _cross_rows(d_i, p_i, dj, pj)
        small = torch.abs(denom) <= EPS
        same_dir = small & (_dot2(d_i[..., None, :], dj) > 0.0)
        mid = 0.5 * (p_i[..., None, :] + pj)
        tproj = numer / torch.where(small, torch.ones_like(denom), denom)
        cross_pt = p_i[..., None, :] + tproj[..., None] * d_i[..., None, :]
        proj_pt = torch.where(small[..., None], mid, cross_pt)
        dd = dj - d_i[..., None, :]
        dd_norm = sqrt_rn(torch.clamp(_dot2(dd, dd), min=1e-300))
        proj_dr = dd / dd_norm[..., None]
        pvalid = lvalid[..., :i] & ~same_dir

        opt = torch.stack([-d_i[..., 1], d_i[..., 0]], dim=-1)
        res2, fail2 = _lp2(proj_pt, proj_dr, pvalid, radius, opt, True)
        result = torch.where((active & (fail2 == i))[..., None], res2, result)
        distance = torch.where(
            active,
            _det(d_i[..., 0], d_i[..., 1],
                 p_i[..., 0] - result[..., 0], p_i[..., 1] - result[..., 1]),
            distance)
    return result


def _orca_lines(rel_pos, rel_vel, comb_r, vel_i, collab_i, inv_dt, inv_th):
    """ORCA half-planes of every (agent i, other j) pair: ``rel_pos =
    pos_j - pos_i``, ``rel_vel = vel_i - vel_j`` ``[..., A, A, 2]``,
    ``comb_r`` ``[..., A, A]``, ``vel_i`` ``[..., A, 1, 2]``, ``collab_i``
    ``[..., A, 1]``.  Returns (point, direction) ``[..., A, A, 2]``."""
    rx, ry = rel_pos[..., 0], rel_pos[..., 1]
    dist_sq = _dot2(rel_pos, rel_pos)
    comb_r_sq = comb_r * comb_r

    # no collision: cut-off circle or a leg of the cone
    w = rel_vel - inv_th * rel_pos
    w_len_sq = _dot2(w, w)
    dot1 = _dot2(w, rel_pos)
    on_cutoff = (dot1 < 0.0) & (dot1 * dot1 > comb_r_sq * w_len_sq)

    w_len = sqrt_rn(torch.clamp(w_len_sq, min=1e-300))
    unit_w = w / w_len[..., None]
    dir_cut = torch.stack([unit_w[..., 1], -unit_w[..., 0]], dim=-1)
    u_cut = (comb_r * inv_th - w_len)[..., None] * unit_w

    leg = sqrt_rn(torch.clamp(dist_sq - comb_r_sq, min=0.0))
    left = _det(rx, ry, w[..., 0], w[..., 1]) > 0.0
    safe_dist_sq = torch.clamp(dist_sq, min=1e-300)[..., None]
    dir_left = torch.stack([rx * leg - ry * comb_r, rx * comb_r + ry * leg],
                           dim=-1) / safe_dist_sq
    dir_right = -torch.stack([rx * leg + ry * comb_r, -rx * comb_r + ry * leg],
                             dim=-1) / safe_dist_sq
    dir_leg = torch.where(left[..., None], dir_left, dir_right)
    u_leg = _dot2(rel_vel, dir_leg)[..., None] * dir_leg - rel_vel

    dir_nc = torch.where(on_cutoff[..., None], dir_cut, dir_leg)
    u_nc = torch.where(on_cutoff[..., None], u_cut, u_leg)

    # collision: cut-off at one time step
    w_c = rel_vel - inv_dt * rel_pos
    w_c_len = sqrt_rn(torch.clamp(_dot2(w_c, w_c), min=1e-300))
    unit_w_c = w_c / w_c_len[..., None]
    dir_col = torch.stack([unit_w_c[..., 1], -unit_w_c[..., 0]], dim=-1)
    u_col = (comb_r * inv_dt - w_c_len)[..., None] * unit_w_c

    colliding = (dist_sq <= comb_r_sq)[..., None]
    direction = torch.where(colliding, dir_col, dir_nc)
    u = torch.where(colliding, u_col, u_nc)
    return vel_i + collab_i[..., None] * u, direction


def orca_solve(pos, vel, pref_vel, radius, max_speed, collab_coeff, valid, dt,
               neighbor_dist, time_horizon, max_neighbors=None):
    """ORCA velocities of every agent from one world snapshot, and the LP
    branch each took.

    Args:
        pos, vel, pref_vel: ``[..., A, 2]``; radius, max_speed,
            collab_coeff, valid: ``[..., A]``; dt, neighbor_dist,
            time_horizon: Python scalars (rounded to the dtype, as the JAX
            step's constants are).
        max_neighbors: cap on the lines per agent (None -> A - 1).

    Returns:
        (new_vel ``[..., A, 2]`` with zero rows for invalid agents,
        lp2_fail ``[..., A]`` int64: the line at which LP2 failed and LP3
        took over, or A - 1 where LP2 succeeded)
    """
    A = pos.shape[-2]
    NL = A - 1
    dtype = pos.dtype
    if max_neighbors is None:
        max_neighbors = NL
    if NL == 0:
        # one agent: no lines, LP2 reduces to the disc clip
        speed_sq = _dot2(pref_vel, pref_vel)
        scale = torch.where(
            speed_sq > max_speed * max_speed,
            max_speed / sqrt_rn(torch.clamp(speed_sq, min=1e-300)),
            torch.ones_like(speed_sq))
        out = torch.where(valid[..., None], pref_vel * scale[..., None],
                          torch.zeros_like(pref_vel))
        return out, torch.zeros(valid.shape, dtype=torch.int64, device=valid.device)

    # the reciprocals the JAX step folds into constants, in the dtype
    inv_th, inv_dt = reciprocal(time_horizon, dtype), reciprocal(dt, dtype)
    nd = (np.float32 if dtype == torch.float32 else np.float64)(neighbor_dist)
    nd_sq = float(nd * nd)

    rel = pos[..., None, :, :] - pos[..., :, None, :]        # [..., i, j, 2]: pos_j - pos_i
    dist_sq = _dot2(rel, rel)
    idx = torch.arange(A, device=pos.device)
    not_self = idx[:, None] != idx[None, :]
    cand = not_self & valid[..., None, :] & (dist_sq < nd_sq)
    key = torch.where(cand, dist_sq, torch.full_like(dist_sq, math.inf))
    # stable ascending order of (key, index); the last (self or a
    # non-candidate) is dropped, as argsort(key)[:NL] would
    order = torch.sort(key, dim=-1, stable=True).indices[..., :NL]      # [..., A, NL]

    pt_n, dr_n = _orca_lines(
        rel, vel[..., :, None, :] - vel[..., None, :, :],
        radius[..., :, None] + radius[..., None, :],
        vel[..., :, None, :], collab_coeff[..., :, None], inv_dt, inv_th)
    # the self row is degenerate (0/0 in float32); it may fill a slot as a
    # non-candidate, so it must be finite
    zero = torch.zeros((), dtype=dtype, device=pos.device)
    pt_n = torch.where(not_self[..., None], pt_n, zero)
    dr_n = torch.where(not_self[..., None], dr_n, zero)

    # "+ 0.0" turns -0.0 into +0.0, as the JAX package's one-hot sum does
    # (the self row adds a +0.0 term); the sign of a zero velocity decides
    # atan2's heading in the RVO wrapper
    order2 = order[..., None].expand(*order.shape, 2)
    pt = torch.gather(pt_n, -2, order2) + 0.0
    dr = torch.gather(dr_n, -2, order2) + 0.0
    lvalid = torch.gather(cand, -1, order)
    if max_neighbors < NL:
        lvalid = lvalid & (torch.arange(NL, device=pos.device) < max_neighbors)

    result, fail_idx = _lp2(pt, dr, lvalid, max_speed, pref_vel, False)
    needs_lp3 = fail_idx < NL
    # LP3 only if some agent's LP2 failed, as the JAX package's lax.cond;
    # reading the flag is one host synchronisation a call
    if bool(needs_lp3.any()):
        lp3_res = _lp3(pt, dr, lvalid, fail_idx, max_speed, result)
        result = torch.where(needs_lp3[..., None], lp3_res, result)
    out = torch.where(valid[..., None], result, torch.zeros_like(result))
    return out, fail_idx


def orca_velocities(pos, vel, pref_vel, radius, max_speed, collab_coeff, valid, dt,
                    neighbor_dist, time_horizon, max_neighbors=None):
    """``[..., A, 2]`` ORCA velocities (:func:`orca_solve` without the
    branch)."""
    return orca_solve(pos, vel, pref_vel, radius, max_speed, collab_coeff, valid, dt,
                      neighbor_dist, time_horizon, max_neighbors)[0]
