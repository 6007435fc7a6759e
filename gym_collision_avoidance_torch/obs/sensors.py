"""Batched sensors (port of ``gym_collision_avoidance_tpu/obs/sensors.py``).

* ``other_agents_states`` replicates ``OtherAgentsStatesSensor.sense`` +
  ``get_clipped_sorted_inds`` (OtherAgentsStatesSensor.py:20-144) over
  ``[E, A]`` batches: the ``round(d, 2)`` key, the stable lexicographic
  order, the sensing horizon and the ``closest`` fallback.  The JAX
  package's one-hot masked sums that pick each slot's row become an index
  gather here.
* ``laserscan`` (a march over the agent-stamped map) and
  ``laserscan_sparse`` (occupancy evaluated analytically, four routes)
  replicate ``LaserScanSensor.sense`` (LaserScanSensor.py:49-101);
  ``occupancy_grid`` replicates ``OccupancyGridSensor.sense``.  The full
  pass of ``laserscan_sparse`` is kernel K2 on the card
  (``ops/raymarch.py``), its beam-compacted pass kernel K3
  (``ops/laser_fused.py``).  The JAX package's TPU workarounds (the
  packed-word compaction, the one-hot wedge compaction) become stable index
  compactions and gathers with the same outputs.

Every quotient by a configured constant is a product with the reciprocal
rounded to the dtype (:func:`maps.grid.reciprocal`), the form XLA compiles
the JAX package's divisions to.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gym_collision_avoidance_torch import config as cfg_mod
from gym_collision_avoidance_torch.core import maths
from gym_collision_avoidance_torch.core.device import as_device_tensor
from gym_collision_avoidance_torch.maps import grid as map_grid
from gym_collision_avoidance_torch.ops import laser_fused, raymarch
from gym_collision_avoidance_torch.ops.raymarch import (
    LASER_MAX_RANGE,
    LASER_NUM_RANGE_SAMPLES,
    LASER_RANGE_RESOLUTION,
    range_samples,
)

# LaserScan geometry (LaserScanSensor.py:32-39).
LASER_MIN_ANGLE = -math.pi / 2
LASER_MAX_ANGLE = math.pi / 2

# Half-width in cells of the band around a source boundary where the
# cell-quantized hit test can disagree with the continuous one
# (sensors.py:207-213 of the JAX package).
_WINDOW_CELL_SLACK = float(np.sqrt(2.0)) + 0.05

# Row index of a disc that cannot be hit (invalid or off-map agent, empty
# candidate slot): di**2 alone exceeds any radius and stays below 2**31.
_NO_DISC_ROW = 40000

# Beam-angle tables by (L, dtype, device), made once: a copy from the host
# on every step would make the host wait for the card.
_ANGLE_TABLES = {}


def beam_angles(L: int, dtype, device) -> torch.Tensor:
    """The beam-angle table: ``np.linspace`` in float64 (the reference's
    ``LaserScanSensor`` table), cast to ``dtype``.  In float32 it is bitwise
    the JAX package's ``jnp.linspace`` table; in float64 ``jnp.linspace``
    is off it by up to an ulp of pi/2 on some entries."""
    key = (L, dtype, torch.device(device))
    table = _ANGLE_TABLES.get(key)
    if table is None:
        table = torch.tensor(np.linspace(LASER_MIN_ANGLE, LASER_MAX_ANGLE, L),
                             device=device).to(dtype)
        _ANGLE_TABLES[key] = table
    return table


def _ego_rows(x, ego_idx):
    """Restrict the agent axis (axis 1) to the listed agents; None keeps all."""
    if ego_idx is None:
        return x
    return x[:, torch.as_tensor(ego_idx, dtype=torch.long, device=x.device)]


def _ego_global(A, ego_idx, device):
    if ego_idx is None:
        return torch.arange(A, device=device)
    return torch.as_tensor(ego_idx, dtype=torch.long, device=device)


def _beam_trig(state, cfg, ego_idx):
    """cos, sin ``[E, Ae, L]`` of every sensing agent's beams."""
    angles = (beam_angles(cfg.laserscan_length, state.pos.dtype, state.pos.device)
              + _ego_rows(state.heading, ego_idx)[..., None])
    return torch.cos(angles), torch.sin(angles)


def laserscan(state, cfg, dynamic_map, ego_idx=None):
    """Ray march over the agent-stamped ``[E, H, W]`` map, with the ego disc
    masked out and the reference's cumsum==1 "last index" rule
    (LaserScanSensor.py:49-101).

    Returns:
        ranges ``[E, Ae, L]`` in meters (Ae = len(ego_idx) or A).
    """
    E = state.pos.shape[0]
    H, W = dynamic_map.shape[1:]
    dtype, device = state.pos.dtype, state.pos.device
    rsamples = range_samples(dtype, device)
    pos_e = _ego_rows(state.pos, ego_idx)
    cos_a, sin_a = _beam_trig(state, cfg, ego_idx)
    gi, gj, ego_in_map = map_grid.world_to_map(pos_e, cfg, (H, W))
    r_cells_sq = map_grid.radius_cells_sq(_ego_rows(state.radius, ego_idx), cfg)
    flat = dynamic_map.reshape(E, H * W)
    cnt = torch.zeros(cos_a.shape, dtype=torch.int32, device=device)
    idx = torch.full(cos_a.shape, -1, dtype=torch.long, device=device)
    for k in range(LASER_NUM_RANGE_SAMPLES):
        px = pos_e[..., 0, None] + rsamples[k] * cos_a
        py = pos_e[..., 1, None] + rsamples[k] * sin_a
        ii, jj, in_map = map_grid.world_to_map(torch.stack([px, py], dim=-1), cfg, (H, W))
        ii_c = ii.clamp(0, H - 1)
        jj_c = jj.clamp(0, W - 1)
        occupied = torch.gather(flat, 1, (ii_c * W + jj_c).reshape(E, -1).long())
        dj, di = jj_c - gj[..., None], ii_c - gi[..., None]
        in_ego = (((dj * dj + di * di).to(dtype) < r_cells_sq[..., None])
                  & ego_in_map[..., None])
        hit = occupied.reshape(cos_a.shape) & ~in_ego & in_map
        cnt = cnt + hit.to(torch.int32)
        idx = torch.where(cnt == 1, k, idx)
    return torch.where(idx >= 0, rsamples[idx.clamp(min=0)],
                       torch.full_like(cos_a, LASER_MAX_RANGE))


def _wedge_screen(state, cfg, pos_e, heading_e, ego_global, num_blocks):
    """Conservative per-(ego, beam-block) disc candidacy ``[E, Ae, B, A]``
    (sensors.py:151-204): a disc can hit a block's beams only if it is in
    sample reach and its tangent cone, inflated by the quantization slack,
    overlaps the block's angular span.  Also returns not_self ``[Ae, A]``."""
    L = cfg.laserscan_length
    cell = cfg.map_grid_cell_size
    A_o = state.pos.shape[1]
    dtype, device = state.pos.dtype, state.pos.device
    r_max = (math.ceil(LASER_MAX_RANGE / LASER_RANGE_RESOLUTION) - 1.0) * LASER_RANGE_RESOLUTION

    rel_x = state.pos[:, None, :, 0] - pos_e[:, :, None, 0]      # [E, Ae, A]
    rel_y = state.pos[:, None, :, 1] - pos_e[:, :, None, 1]
    d = maths.sqrt_rn(rel_x * rel_x + rel_y * rel_y)
    rhit = (state.radius * map_grid.reciprocal(cell, dtype) + 1.5) * cell  # [E, A]
    reach_ok = d <= r_max + rhit[:, None, :] + 1e-3

    phi = torch.atan2(rel_y, rel_x) - heading_e[..., None]
    phi = torch.remainder(phi + math.pi, 2.0 * math.pi) - math.pi
    ratio = torch.clamp(rhit[:, None, :] / torch.clamp(d, min=1e-9), 0.0, 1.0)
    half = torch.asin(ratio) + 1e-3
    inside = d <= rhit[:, None, :]

    spans = beam_angles(L, dtype, device).reshape(num_blocks, L // num_blocks)
    lo_b, hi_b = spans[:, 0], spans[:, -1]                       # [B]
    isect = torch.zeros(phi.shape + (num_blocks,), dtype=torch.bool, device=device)
    for shift in (-2.0 * math.pi, 0.0, 2.0 * math.pi):
        pc = (phi + shift)[..., None]
        isect = isect | ((pc - half[..., None] <= hi_b) & (pc + half[..., None] >= lo_b))
    ok = (isect | inside[..., None]) & reach_ok[..., None]       # [E, Ae, A, B]
    not_self = torch.arange(A_o, device=device)[None, :] != ego_global[:, None]
    return ok.movedim(-1, 2), not_self


def _static_cell_sources(static_cells, cfg, dtype):
    """Static occupied cells as windowed sources (sensors.py:609-623): the
    cell, rsq = 1 (so the integer disc test is cell equality) and the
    cell's world centre for the analytic band."""
    cell = cfg.map_grid_cell_size
    oi, oj = map_grid.map_origin(cfg)
    ci = static_cells[:, 0]
    cj = static_cells[:, 1]
    cx = (cj.to(dtype) + 0.5 - oj) * cell
    cy = (oi - ci.to(dtype) - 0.5) * cell
    rsq = torch.ones(static_cells.shape[0], dtype=dtype, device=static_cells.device)
    return ci, cj, rsq, cx, cy


def _source_band(pos_e, cos_b, sin_b, rsq_d, cx_d, cy_d, cell):
    """Per (ego, block, source, beam): the analytic band of the slack-
    inflated source, ``(t_c, bb, disc, half_o)`` ``[E, Ae, B, S, Lb]``.
    Sources are ``[E, Ae, B, S]``; beams ``[E, Ae, B, Lb]``."""
    relx = cx_d - pos_e[:, :, None, None, 0]
    rely = cy_d - pos_e[:, :, None, None, 1]
    t_c = relx[..., None] * cos_b[:, :, :, None, :] + rely[..., None] * sin_b[:, :, :, None, :]
    bb = (relx * relx + rely * rely)[..., None] - t_c * t_c
    r_out = (maths.sqrt_rn(rsq_d) + _WINDOW_CELL_SLACK) * cell
    disc = (r_out * r_out)[..., None] - bb
    return t_c, bb, disc, maths.sqrt_rn(torch.clamp(disc, min=0.0))


def _windowed_first_two_hits(pos_e, gi_e, gj_e, rsq_e, cos_b, sin_b,
                             gi_d, gj_d, rsq_d, cx_d, cy_d, span_ok, cfg, Wn):
    """Ranges ``[E, Ae, L]`` and the span overflow ``[E]`` via per-source
    entry windows (sensors.py:241-375): the exact cell test on ``Wn``
    samples from one sample before each source's analytic entry, every
    source on every beam of its block.  Plain PyTorch on both devices.

    Sources ``[E, Ae, B, S]``; beams ``cos_b``/``sin_b`` ``[E, Ae, L]``.
    """
    H, W, oi, oj, inv_cell, res, inv_res, t_max = laser_fused.consts(cfg, pos_e.dtype)
    R = LASER_NUM_RANGE_SAMPLES
    dtype = pos_e.dtype
    E, Ae, L = cos_b.shape
    B = gi_d.shape[2]
    cb = cos_b.reshape(E, Ae, B, -1)
    sb = sin_b.reshape(E, Ae, B, -1)
    cell = cfg.map_grid_cell_size
    t_c, bb, disc, half_o = _source_band(pos_e, cb, sb, rsq_d, cx_d, cy_d, cell)
    t_lo = t_c - half_o
    k0 = torch.clamp(torch.floor(t_lo * inv_res).to(torch.int32) - 1, 0, R)
    k0 = torch.where(disc > 0.0, k0, R)

    # the span each (ego, source, beam) needs for exactness
    t_hi = t_c + half_o
    r_in = torch.clamp(maths.sqrt_rn(rsq_d) - _WINDOW_CELL_SLACK, min=0.0) * cell
    inner = (r_in * r_in)[..., None] - bb
    half_i = maths.sqrt_rn(torch.clamp(inner, min=0.0))
    t_g = t_c - half_i
    covered2 = (inner > 0.0) & (t_g + res <= t_c + half_i)
    t_need = torch.where(covered2, t_g + res, t_hi)
    relevant = (disc > 0.0) & (t_hi > 0.0) & (t_lo < t_max) & span_ok[..., None]
    k0s = torch.clamp(torch.floor(torch.clamp(t_lo, 0.0, t_max) * inv_res).to(torch.int32) - 1,
                      min=0)
    k1n = torch.floor(torch.clamp(t_need, 0.0, t_max) * inv_res).to(torch.int32) + 1
    overflow = (relevant & (k1n - k0s + 1 > Wn)).flatten(1).any(dim=1)

    x0 = pos_e[:, :, None, None, None, 0]
    y0 = pos_e[:, :, None, None, None, 1]
    c5, s5 = cb[:, :, :, None, :], sb[:, :, :, None, :]
    idx = []
    for w in range(Wn):
        k = k0 + w
        rr = k.to(dtype) * res
        px = x0 + rr * c5
        py = y0 + rr * s5
        ii = torch.floor(oi - py * inv_cell).to(torch.int32)
        jj = torch.floor(oj + px * inv_cell).to(torch.int32)
        in_map = (ii >= 0) & (jj >= 0) & (ii < H) & (jj < W)
        di, dj = ii - gi_d[..., None], jj - gj_d[..., None]
        in_src = (di * di + dj * dj).to(dtype) < rsq_d[..., None]
        dei = ii - gi_e[:, :, None, None, None]
        dej = jj - gj_e[:, :, None, None, None]
        in_ego = (dei * dei + dej * dej).to(dtype) < rsq_e[:, :, None, None, None]
        hit = in_src & ~in_ego & in_map & (k < R)
        idx.append(torch.where(hit, k, R))
    ranges = laser_fused.ranges_from_hits(torch.stack(idx, dim=3).flatten(3, 4), dtype)
    return ranges.reshape(E, Ae, L), overflow


def _windowed_beam_compacted(pos_e, gi_e, gj_e, rsq_e, cos_b, sin_b,
                             gi_d, gj_d, rsq_d, cx_d, cy_d, span_ok, cfg, Wn):
    """Entry windows with per-beam source compaction into ``Cs =
    cfg.laserscan_beam_slots`` slots (sensors.py:378-606): ranges
    ``[E, Ae, L]`` and the exactness overflow ``[E]``.

    The closed-form window-span guard (no beam axis) and the per-source
    scalars are computed here; the screen, compaction and window pass are
    kernel K3 on the card (:func:`ops.laser_fused.beam_compacted`).
    """
    dtype = pos_e.dtype
    cell = cfg.map_grid_cell_size
    _, _, _, _, _, res, inv_res, _ = laser_fused.consts(cfg, dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    res_half = float(np_dtype(res) / np_dtype(2.0))
    res_half_sq = float(np_dtype(res_half) * np_dtype(res_half))

    r_out = (maths.sqrt_rn(rsq_d) + _WINDOW_CELL_SLACK) * cell
    r_in = torch.clamp(maths.sqrt_rn(rsq_d) - _WINDOW_CELL_SLACK, min=0.0) * cell
    dmax = 2.0 * maths.sqrt_rn(torch.clamp(r_out * r_out - r_in * r_in, min=0.0) + res_half_sq)
    span_bound = torch.floor((dmax + res_half) * inv_res).to(torch.int32) + 4
    span_overflow = ((rsq_d > 0) & span_ok & (span_bound > Wn)).flatten(1).any(dim=1)

    floor_rsq = torch.floor(rsq_d)
    irsq = (floor_rsq + (rsq_d > floor_rsq).to(dtype)).to(torch.int32)
    relx = cx_d - pos_e[:, :, None, None, 0]
    rely = cy_d - pos_e[:, :, None, None, 1]
    ranges, slot_ovf = laser_fused.beam_compacted(
        pos_e.contiguous(), gi_e.contiguous(), gj_e.contiguous(), rsq_e.contiguous(),
        cos_b.contiguous(), sin_b.contiguous(), gi_d.contiguous(), gj_d.contiguous(),
        irsq.contiguous(), relx.contiguous(), rely.contiguous(),
        (relx * relx + rely * rely).contiguous(), (r_out * r_out).contiguous(),
        span_ok.contiguous(), cfg, Wn, cfg.laserscan_beam_slots,
    )
    return ranges, span_overflow | slot_ovf.flatten(1).any(dim=1)


def _with_static_sources(static_cells, cfg, dtype, gi_d, gj_d, rsq_d, cx_d, cy_d, span_ok):
    """Append the static occupied cells to every (ego, block) source set;
    their padding rows (-1, -1) are left out of the guards."""
    if static_cells.shape[0] == 0:
        return gi_d, gj_d, rsq_d, cx_d, cy_d, span_ok
    ci, cj, rsq_s, cx_s, cy_s = _static_cell_sources(static_cells, cfg, dtype)
    lead = gi_d.shape[:-1]

    def app(a, b):
        return torch.cat([a, b.to(a.dtype).expand(*lead, b.shape[0])], dim=-1)

    return (app(gi_d, ci), app(gj_d, cj), app(rsq_d, rsq_s), app(cx_d, cx_s),
            app(cy_d, cy_s), app(span_ok, ci >= 0))


def laserscan_sparse(state, cfg, static_cells, ego_idx=None, return_overflow=False):
    """Laserscan without a rasterized map (sensors.py:731-1037): agent discs
    by the disc inequality on the sample's cell, static obstacles by the
    occupied-cell list.  Same ranges as :func:`laserscan`.

    Routes, chosen by the config as in the JAX package:

    * full pass (no window, no wedge): kernel K2 on the card;
    * ``laserscan_num_candidate_discs = C``: per 128-beam block, only the
      discs passing the conservative wedge screen (at most C of them);
    * ``laserscan_entry_window = Wn``: the exact test on Wn-sample windows
      at each source's analytic entry; with ``laserscan_beam_slots = Cs``
      also compacted to Cs sources per beam, kernel K3 on the card.

    The fast routes are exact unless a guard trips: ``return_overflow``
    adds ``[E]`` bool, True where a slot or window overflowed.

    Args:
        static_cells: ``[S, 2]`` int32 occupied cells padded with -1 rows
            (:func:`maps.grid.occupied_cell_list`).
        ego_idx: agent indices to sense for; None senses for all.

    Returns:
        ranges ``[E, Ae, L]``, or ``(ranges, overflow [E])``.
    """
    E, A_o = state.pos.shape[:2]
    L = cfg.laserscan_length
    dtype, device = state.pos.dtype, state.pos.device
    H, W = map_grid.map_shape(cfg)
    static_cells = as_device_tensor(static_cells, torch.int32, device)
    pos_e = _ego_rows(state.pos, ego_idx)
    cos_a, sin_a = _beam_trig(state, cfg, ego_idx)
    gi, gj, center_in_map = map_grid.world_to_map(state.pos, cfg, (H, W))
    r_cells_sq = map_grid.radius_cells_sq(state.radius, cfg)
    disc_valid = center_in_map & state.valid
    gi = torch.where(disc_valid, gi, _NO_DISC_ROW)
    gi_e, gj_e, rsq_e = (_ego_rows(x, ego_idx) for x in (gi, gj, r_cells_sq))
    ego_global = _ego_global(A_o, ego_idx, device)

    C = cfg.laserscan_num_candidate_discs
    Wn = cfg.laserscan_entry_window
    if cfg.laserscan_beam_slots is not None and Wn is None:
        raise ValueError("cfg.laserscan_beam_slots requires cfg.laserscan_entry_window")
    use_wedge = C is not None and C < A_o - 1 and L % 128 == 0
    windowed = (_windowed_beam_compacted if cfg.laserscan_beam_slots is not None
                else _windowed_first_two_hits)
    Ae = pos_e.shape[1]

    if not use_wedge:
        if Wn is None:
            out = raymarch.raymarch(
                pos_e.contiguous(), cos_a.contiguous(), sin_a.contiguous(),
                gi_e.contiguous(), gj_e.contiguous(), rsq_e.contiguous(),
                gi.contiguous(), gj.contiguous(), r_cells_sq.contiguous(),
                static_cells.contiguous(), cfg)
            no_ovf = torch.zeros(E, dtype=torch.bool, device=device)
            return (out, no_ovf) if return_overflow else out
        # every agent is a source of the one block; the ego's own disc
        # stays in (its hits always cancel against the ego test) but, like
        # invalid discs, is left out of the guards
        def per_ego(x):
            return x[:, None, None, :].expand(E, Ae, 1, A_o)

        span_ok = (disc_valid[:, None, :]
                   & (torch.arange(A_o, device=device)[None, :] != ego_global[:, None]))
        srcs = _with_static_sources(
            static_cells, cfg, dtype, per_ego(gi), per_ego(gj), per_ego(r_cells_sq),
            per_ego(state.pos[..., 0]), per_ego(state.pos[..., 1]), span_ok[:, :, None, :])
        out, ovf = windowed(pos_e, gi_e, gj_e, rsq_e, cos_a, sin_a, *srcs, cfg, Wn)
        return (out, ovf) if return_overflow else out

    # Wedge-culled route: each 128-beam block keeps its first C candidates
    # in agent order (a stable index compaction of the screen).
    B = L // 128
    heading_e = _ego_rows(state.heading, ego_idx)
    ok, not_self = _wedge_screen(state, cfg, pos_e, heading_e, ego_global, B)
    ok = ok & disc_valid[:, None, None, :] & not_self[None, :, None, :]     # [E, Ae, B, A]
    n_ok = ok.sum(dim=-1)
    wedge_ovf = (n_ok > C).flatten(1).any(dim=1)
    order = torch.argsort((~ok).to(torch.uint8), dim=-1, stable=True)[..., :C]
    occupied = torch.arange(order.shape[-1], device=device) < n_ok[..., None]  # [E, Ae, B, C]

    def compact(v, empty):
        """[E, A] -> [E, Ae, B, C] candidate values; ``empty`` in free slots."""
        picked = torch.gather(v[:, None, None, :].expand(E, Ae, B, A_o), 3, order)
        return torch.where(occupied, picked, torch.full_like(picked, empty))

    # The JAX package compacts through float32 sums: the squared radius and
    # the centre carry float32 rounding into a float64 run, and so do these.
    f32 = torch.float32
    gi_c = compact(gi, _NO_DISC_ROW)
    gj_c = compact(gj, 0)
    rsq_c = compact(r_cells_sq.to(f32), 0.0).to(dtype)
    cos_b = cos_a.contiguous()
    sin_b = sin_a.contiguous()
    if Wn is None:
        cb = cos_b.reshape(E, Ae, B, 128)
        sb = sin_b.reshape(E, Ae, B, 128)
        out = torch.cat([raymarch.march_plain(
            pos_e, cb[:, :, b], sb[:, :, b], gi_e, gj_e, rsq_e, gi_c[:, :, b], gj_c[:, :, b],
            rsq_c[:, :, b], static_cells, cfg) for b in range(B)], dim=-1)
        return (out, wedge_ovf) if return_overflow else out
    cx_c = compact(state.pos[..., 0].to(f32), 1e7).to(dtype)
    cy_c = compact(state.pos[..., 1].to(f32), 0.0).to(dtype)
    span_ok = torch.ones(gi_c.shape, dtype=torch.bool, device=device)
    srcs = _with_static_sources(static_cells, cfg, dtype, gi_c, gj_c, rsq_c, cx_c, cy_c, span_ok)
    out, ovf = windowed(pos_e, gi_e, gj_e, rsq_e, cos_b, sin_b, *srcs, cfg, Wn)
    return (out, ovf | wedge_ovf) if return_overflow else out


def laserscan_window_span(state, cfg, static_cells=None, ego_idx=None) -> int:
    """Diagnostic (sensors.py:626-704): the widest window, in range samples,
    that any (env, ego, source, beam) needs for the windowed routes to equal
    the full pass.  A window ``Wn`` is exact for these states iff this is at
    most ``Wn``."""
    dtype, device = state.pos.dtype, state.pos.device
    E, A_o = state.pos.shape[:2]
    cell = cfg.map_grid_cell_size
    res = LASER_RANGE_RESOLUTION
    R = LASER_NUM_RANGE_SAMPLES
    H, W = map_grid.map_shape(cfg)
    inv_res = map_grid.reciprocal(res, dtype)
    t_max = (R - 1) * res

    pos_e = _ego_rows(state.pos, ego_idx)
    Ae = pos_e.shape[1]
    cos_b, sin_b = _beam_trig(state, cfg, ego_idx)
    _gi, _gj, center_in_map = map_grid.world_to_map(state.pos, cfg, (H, W))
    ego_global = _ego_global(A_o, ego_idx, device)
    not_self = torch.arange(A_o, device=device)[None, :] != ego_global[:, None]
    src_ok = (center_in_map & state.valid)[:, None, :] & not_self[None]   # [E, Ae, A]
    rsq = map_grid.radius_cells_sq(state.radius, cfg)
    cx, cy = state.pos[..., 0], state.pos[..., 1]
    if static_cells is not None and len(static_cells) > 0:
        cells = as_device_tensor(static_cells, torch.int32, device)
        _ci, _cj, rsq_s, cx_s, cy_s = _static_cell_sources(cells, cfg, dtype)
        S = cells.shape[0]
        rsq = torch.cat([rsq, rsq_s.expand(E, S)], dim=1)
        cx = torch.cat([cx, cx_s.expand(E, S)], dim=1)
        cy = torch.cat([cy, cy_s.expand(E, S)], dim=1)
        src_ok = torch.cat([src_ok, (cells[:, 0] >= 0).expand(E, Ae, S)], dim=2)

    def blocked(x):                                               # [E, S] -> [E, Ae, 1, S]
        return x[:, None, None, :].expand(E, Ae, 1, x.shape[1])

    t_c, bb, disc, half_o = _source_band(pos_e, cos_b[:, :, None], sin_b[:, :, None],
                                         blocked(rsq), blocked(cx), blocked(cy), cell)
    r_in = torch.clamp(maths.sqrt_rn(rsq) - _WINDOW_CELL_SLACK, min=0.0) * cell
    inner = blocked(r_in * r_in)[..., None] - bb
    half_i = maths.sqrt_rn(torch.clamp(inner, min=0.0))
    t_lo = t_c - half_o
    t_hi = t_c + half_o
    t_g = t_c - half_i
    covered2 = (inner > 0.0) & (t_g + res <= t_c + half_i)
    t_need = torch.where(covered2, t_g + res, t_hi)
    relevant = ((disc > 0.0) & (t_hi > 0.0) & (t_lo < t_max)
                & src_ok[:, :, None, :, None])
    k0 = torch.clamp(torch.floor(torch.clamp(t_lo, 0.0, t_max) * inv_res).to(torch.int32) - 1,
                     min=0)
    k1n = torch.floor(torch.clamp(t_need, 0.0, t_max) * inv_res).to(torch.int32) + 1
    span = torch.where(relevant, k1n - k0 + 1, 0)
    return int(span.max()) if span.numel() else 0


def laserscan_wedge_candidate_counts(state, cfg, ego_idx=None, num_blocks=4):
    """Diagnostic (sensors.py:707-728): ``[E, Ae, B]`` discs passing the
    wedge screen per (ego, block).  ``laserscan_num_candidate_discs = C``
    is exact for these states iff this never exceeds C."""
    A_o = state.pos.shape[1]
    device = state.pos.device
    H, W = map_grid.map_shape(cfg)
    pos_e = _ego_rows(state.pos, ego_idx)
    heading_e = _ego_rows(state.heading, ego_idx)
    ego_global = _ego_global(A_o, ego_idx, device)
    _gi, _gj, center_in_map = map_grid.world_to_map(state.pos, cfg, (H, W))
    disc_valid = center_in_map & state.valid
    ok, not_self = _wedge_screen(state, cfg, pos_e, heading_e, ego_global, num_blocks)
    ok = ok & disc_valid[:, None, None, :] & not_self[None, :, None, :]
    return ok.sum(dim=-1, dtype=torch.int32)


def occupancy_grid(state, cfg, dynamic_map):
    """The 5 x 5 m ego-centred crop ``[E, A, 50, 50]`` of the ``[E, H, W]``
    dynamic map (OccupancyGridSensor.py:24-88); cells off the map are
    False."""
    E = state.pos.shape[0]
    H, W = dynamic_map.shape[1:]
    cell = cfg.map_grid_cell_size
    n_i, n_j = int(5.0 / cell), int(5.0 / cell)
    i_low, _, _ = map_grid.world_to_map(state.pos + 2.5, cfg, (H, W))   # 5 m / 2
    _, j_low, _ = map_grid.world_to_map(state.pos - 2.5, cfg, (H, W))
    rows = i_low[..., None] + torch.arange(n_i, device=state.pos.device)    # [E, A, n_i]
    cols = j_low[..., None] + torch.arange(n_j, device=state.pos.device)
    rv = (rows >= 0) & (rows < H)
    cv = (cols >= 0) & (cols < W)
    flat_idx = (rows.clamp(0, H - 1)[..., :, None] * W
                + cols.clamp(0, W - 1)[..., None, :]).long()               # [E, A, n_i, n_j]
    vals = torch.gather(dynamic_map.reshape(E, 1, H * W).expand(E, flat_idx.shape[1], H * W),
                        2, flat_idx.flatten(2)).reshape(flat_idx.shape)
    return vals & rv[..., :, None] & cv[..., None, :]


def _lex_cmp(keys, idx):
    """``[..., N, N]``: entry j sorts before entry i (keys primary first,
    then index)."""
    cmp = idx[:, None] > idx[None, :]                     # [N, N]: j before i
    for k in reversed(keys):
        less = k[..., :, None] > k[..., None, :]          # k_j < k_i
        eq = k[..., :, None] == k[..., None, :]
        cmp = less | (eq & cmp)
    return cmp


def _lex_rank(keys, idx):
    """Stable lexicographic rank of each entry of the last axis among all
    entries (``sensors.py:1069-1088``): ``keys`` is a tuple of ``[..., N]``
    tensors, primary first; ties beyond the keys break by index, as
    ``np.lexsort`` does.  Pairwise O(N^2), as in the JAX package: SA-CADRL
    ranks the A agents of an env."""
    return torch.sum(_lex_cmp(keys, idx), dim=-1)


def _lex_rank_masked(keys, idx, count_mask):
    """:func:`_lex_rank` counting only ``count_mask``-True competitors
    (``sensors.py:1091-1116``).  The main path has N = 4."""
    return torch.sum(_lex_cmp(keys, idx) & count_mask[..., None, :], dim=-1)


def other_agents_states(state, cfg):
    """Sense the K closest other agents for every host agent.

    Returns:
        (rows [E, A, K, 7], closest [E, A, 7], counts [E, A] int32): the
        7-tuple is [p_parallel_ego, p_orthog_ego, v_parallel_ego,
        v_orthog_ego, other_radius, combined_radius, dist_2_other]
        (OtherAgentsStatesSensor.py:128-134); empty slots are zero;
        ``closest`` keeps its previous value when nothing is visible.
    """
    E, A = state.pos.shape[:2]
    K = cfg.max_num_other_agents_observed
    device = state.pos.device

    # [E, A_host, A_other] relative quantities, in the JAX package's order.
    pos, vel = state.pos, state.vel
    rel_x = pos[:, None, :, 0] - pos[:, :, None, 0]
    rel_y = pos[:, None, :, 1] - pos[:, :, None, 1]
    dist_centers = maths.sqrt_rn(rel_x * rel_x + rel_y * rel_y)
    prll_x, prll_y = state.ref_prll[..., 0, None], state.ref_prll[..., 1, None]
    orth_x, orth_y = state.ref_orth[..., 0, None], state.ref_orth[..., 1, None]
    p_par = rel_x * prll_x + rel_y * prll_y
    p_orth = rel_x * orth_x + rel_y * orth_y
    v_par = vel[:, None, :, 0] * prll_x + vel[:, None, :, 1] * prll_y
    v_orth = vel[:, None, :, 0] * orth_x + vel[:, None, :, 1] * orth_y
    other_r = state.radius[:, None, :].expand(E, A, A)
    combined_r = state.radius[:, :, None] + state.radius[:, None, :]
    d2other = dist_centers - combined_r

    eye = torch.eye(A, dtype=torch.bool, device=device)
    # Agents beyond the sensing horizon are dropped
    # (OtherAgentsStatesSensor.py:90-92).
    visible = ~eye & state.valid[:, None, :] & (dist_centers <= cfg.sensing_horizon)

    # Sort keys (OtherAgentsStatesSensor.py:103); torch.round is
    # round-half-even, like jnp.round.  The divisor is a tensor because
    # CUDA turns division by a Python scalar into a multiply by its
    # reciprocal, which would make the card's keys differ from the CPU's.
    hundred = torch.full((), 100.0, dtype=d2other.dtype, device=device)
    d_rounded = torch.round(d2other * 100.0) / hundred

    method = cfg.agent_sorting_method
    idx = torch.arange(A, device=device)
    if method == cfg_mod.SORT_TIME_TO_IMPACT:
        tti = maths.compute_time_to_impact(
            pos[:, :, None, :], pos[:, None, :, :],
            vel[:, :, None, :], vel[:, None, :, :], combined_r,
        )
        clip_keys = (-tti, -d_rounded, p_orth)
    elif method in (cfg_mod.SORT_CLOSEST_FIRST, cfg_mod.SORT_CLOSEST_LAST):
        clip_keys = (d_rounded, p_orth)
    else:
        raise ValueError(f"unknown agent_sorting_method {method}")

    rank = _lex_rank_masked(clip_keys, idx, visible)          # [E, A, A]
    selected = visible & (rank < K)
    # Re-sort the clipped K by the final scheme (":41-50"); closest_first
    # and time_to_impact re-sort by the clip key, a no-op on a stable order.
    if method == cfg_mod.SORT_CLOSEST_LAST:
        rank = _lex_rank_masked((-d_rounded, p_orth), idx, selected)

    # Slot k of host h holds the selected agent of rank k: a gather.
    slot = torch.arange(K, device=device)
    onehot = (rank[:, :, None, :] == slot[:, None]) & selected[:, :, None, :]  # [E, A, K, A]
    has = onehot.any(dim=-1)                                              # [E, A, K]
    src = onehot.to(torch.uint8).argmax(dim=-1)                           # [E, A, K]
    fields = torch.stack((p_par, p_orth, v_par, v_orth, other_r, combined_r, d2other),
                         dim=-1)                                          # [E, A, A, 7]
    rows = torch.gather(fields, 2, src[..., None].expand(E, A, K, 7))
    rows = torch.where(has[..., None], rows, torch.zeros_like(rows))

    counts = torch.clamp(visible.sum(dim=-1), max=K).to(torch.int32)
    closest = torch.where((counts > 0)[..., None], rows[:, :, 0, :],
                          state.other_agent_states)
    return rows, closest, counts
