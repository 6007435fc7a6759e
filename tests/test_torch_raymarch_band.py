"""K2's band design (``csrc/raymarch.cu``) modelled in plain PyTorch and held
against ``ops/raymarch.py:raymarch_plain`` on the CPU.

The kernel gives every source (an agent disc, or a static occupied cell) a
band of range samples from the beam's distance to the source's cell centre,
in cells, inflated by sqrt(2)/2 + 0.05; it runs the exact per-sample test
only inside the bands and merges the hits into the two smallest distinct
indices.  Each warp first drops the sources that miss the wedge of its 32
beams.  This file holds a model of that algorithm, with the kernel's band
and wedge formulas in the kernel's order of operations, and checks it on
seeded edge cases, in float32 and float64:

* every hit of the brute-force test, per (sample, source), lies inside that
  source's band on a beam whose wedge keeps the source, so the margins are
  conservative;
* the band-limited march with the two-smallest merge equals
  ``raymarch_plain`` bitwise.

The cases: random hosts and beams; beams tangent to a disc's inflated and
true radius; hosts and samples on cell boundaries; discs at the map edge and
off it (the row sentinel); hosts inside another disc; map 002's cells; and
A = 5, 20 and 40.  ``chip_smoke.py`` runs the CUDA kernel on the same cases
(:func:`build_case`) and counts K2's work with :func:`band_work`, so this
module imports neither JAX nor anything that ``tests/conftest.py`` sets up.
"""

import functools
import math

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig, init_state
from gym_collision_avoidance_torch.core.maths import sqrt_rn
from gym_collision_avoidance_torch.maps import grid
from gym_collision_avoidance_torch.obs import sensors
from gym_collision_avoidance_torch.ops import raymarch

R = raymarch.LASER_NUM_RANGE_SAMPLES
SLACK = math.sqrt(2.0) / 2 + 0.05          # csrc/raymarch.cu: kSlack, in cells


# ------------------------------------------------------------------ the model

def raymarch_args(cfg, state, cells):
    """The arguments the full pass of ``laserscan_sparse`` hands to K2 (the
    march itself is not run)."""
    calls = []
    orig = raymarch.raymarch

    def spy(*args):
        calls.append(args)

    raymarch.raymarch = spy
    try:
        sensors.laserscan_sparse(state, cfg, cells)
    finally:
        raymarch.raymarch = orig
    assert len(calls) == 1
    return calls[0]


def _sources(args):
    """The kernel's source table, the env's discs then the static cells:
    cell centres ``(src_j, src_i)`` and inflated radii ``r_out`` ``[E, S]``
    (a static cell off the map has a NaN centre), the host's own disc
    ``own`` ``[E, Ae, S]``, and the beam origins ``(bj, bi)`` ``[E, Ae]``,
    all in cells."""
    pos_e, _cos_a, _sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq, cells, cfg = args
    dtype = pos_e.dtype
    E, n_cells = pos_e.shape[0], cells.shape[0]
    H, W = grid.map_shape(cfg)
    oi, oj = grid.map_origin(cfg)
    inv_cell = grid.reciprocal(cfg.map_grid_cell_size, dtype)
    slack = torch.tensor(SLACK, dtype=dtype, device=pos_e.device)
    ci, cj = cells[:, 0], cells[:, 1]
    on_map = (ci >= 0) & (ci < H) & (cj >= 0) & (cj < W)

    def cell_centre(v):                   # float32, NaN off the map, as the kernel keeps it
        return torch.where(on_map, v.to(torch.float32) + 0.5, float("nan")).to(dtype)

    src_j = torch.cat([gj.to(dtype) + 0.5, cell_centre(cj).expand(E, n_cells)], dim=1)
    src_i = torch.cat([gi.to(dtype) + 0.5, cell_centre(ci).expand(E, n_cells)], dim=1)
    r_out = torch.cat([sqrt_rn(rsq) + slack, slack.expand(E, n_cells)], dim=1)
    own = ((gi[:, None, :] == gi_e[..., None]) & (gj[:, None, :] == gj_e[..., None])
           & (rsq[:, None, :] == rsq_e[..., None]))                       # [E, Ae, A]
    own = torch.cat([own, own.new_zeros(own.shape[:2] + (n_cells,))], dim=2)
    bj = oj + pos_e[..., 0] * inv_cell
    bi = oi - pos_e[..., 1] * inv_cell
    return src_j, src_i, r_out, own, bj, bi


def wedge_keep(args):
    """``[E, Ae, S, L]``: the kernel's per-warp pre-screen of every source
    against the wedge of the warp's 32 adjacent beams, repeated on each of
    them; None when 32 does not divide L (the kernel's warps then screen
    every source on every lane)."""
    pos_e, cos_a, sin_a, *_rest, cfg = args
    E, Ae, L = cos_a.shape
    if L % 32:
        return None
    src_j, src_i, r_out, _own, bj, bi = _sources(args)
    reach = torch.tensor(R, dtype=pos_e.dtype) / (cfg.map_grid_cell_size
                                                 / raymarch.LASER_RANGE_RESOLUTION)
    relj = src_j[:, None, :, None] - bj[..., None, None]                 # [E, Ae, S, 1]
    reli = src_i[:, None, :, None] - bi[..., None, None]
    c = cos_a.reshape(E, Ae, 1, L // 32, 32)
    s = sin_a.reshape(E, Ae, 1, L // 32, 32)
    side_cw = -(c[..., 0] * reli + s[..., 0] * relj)                    # [E, Ae, S, L/32]
    side_ccw = -(c[..., 31] * reli + s[..., 31] * relj)
    r = r_out[:, None, :, None]
    far = reach + r
    near = (((relj * relj + reli * reli) <= far * far)
            & ~(side_cw < -r) & ~(side_ccw > r))
    return near.repeat_interleave(32, dim=-1)


def bands(args):
    """``(lo, hi, cross)`` ``[E, Ae, S, L]``: the band of every source on
    every beam as ``csrc/raymarch.cu:source_band`` computes it, for the
    sources the warp's wedge keeps.  The host's own disc and static cells
    off the map never cross."""
    pos_e, cos_a, sin_a, *_rest, cfg = args
    kpc = cfg.map_grid_cell_size / raymarch.LASER_RANGE_RESOLUTION
    src_j, src_i, r_out, own, bj, bi = _sources(args)
    relj = src_j[:, None, :, None] - bj[..., None, None]                 # [E, Ae, S, 1]
    reli = src_i[:, None, :, None] - bi[..., None, None]
    c, s = cos_a[:, :, None, :], sin_a[:, :, None, :]
    tc = relj * c - reli * s
    bb = (relj * relj + reli * reli) - tc * tc
    disc = (r_out * r_out)[:, None, :, None] - bb
    half = sqrt_rn(torch.clamp(disc, min=0.0))
    flo = torch.clamp(torch.floor((tc - half) * kpc) - 1, min=0.0)
    fhi = torch.clamp(torch.floor((tc + half) * kpc) + 1, max=R - 1.0)
    cross = (disc > 0) & (flo <= fhi) & ~own[..., None]
    keep = wedge_keep(args)
    if keep is not None:
        cross = cross & keep
    return flo.long(), fhi.long(), cross


def source_hits(args):
    """For each source in band order, the brute-force hits ``[E, Ae, L, R]``
    of ``march_plain``: on the map, inside the source, outside the host's
    own disc, every sample by the same rounded arithmetic."""
    pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq, cells, cfg = args
    dtype = pos_e.dtype
    H, W = grid.map_shape(cfg)
    oi, oj = grid.map_origin(cfg)
    inv_cell = grid.reciprocal(cfg.map_grid_cell_size, dtype)
    rs = raymarch.range_samples(dtype, pos_e.device)
    px = pos_e[..., 0, None, None] + rs * cos_a[..., None]
    py = pos_e[..., 1, None, None] + rs * sin_a[..., None]
    ii = torch.floor(oi - py * inv_cell).to(torch.int32)
    jj = torch.floor(oj + px * inv_cell).to(torch.int32)
    dei, dej = ii - gi_e[..., None, None], jj - gj_e[..., None, None]
    free = ((ii >= 0) & (jj >= 0) & (ii < H) & (jj < W)
            & ~((dei * dei + dej * dej).to(dtype) < rsq_e[..., None, None]))
    for a in range(gi.shape[1]):
        di, dj = ii - gi[:, a, None, None, None], jj - gj[:, a, None, None, None]
        yield free & ((di * di + dj * dj).to(dtype) < rsq[:, a, None, None, None])
    for ci, cj in cells.tolist():
        yield free & (ii == ci) & (jj == cj)


def band_march(args):
    """The kernel's algorithm: sources in order, the exact test inside each
    band below the current second hit, hits merged into the two smallest
    distinct indices m1 < m2.  Returns the ranges ``[E, Ae, L]``, the count
    of brute-force hits outside their source's band (0 if the bands are
    conservative), the count of hits, and the samples the march tested."""
    lo, hi, cross = bands(args)
    k = torch.arange(R, device=lo.device)
    m1 = torch.full(args[1].shape, R, dtype=torch.long, device=lo.device)
    m2 = m1.clone()
    outside = hits = tested = 0
    for q, hit in enumerate(source_hits(args)):
        in_band = (cross[:, :, q, :, None] & (k >= lo[:, :, q, :, None])
                   & (k <= hi[:, :, q, :, None]))
        outside += int((hit & ~in_band).sum())
        hits += int(hit.sum())
        live = in_band & (k < m2[..., None])
        tested += int(live.sum())
        idx = torch.where(hit & live, k, R)
        c1 = idx.amin(dim=-1)
        c2 = torch.where(idx > c1[..., None], idx, R).amin(dim=-1)
        both = torch.stack([m1, m2, c1, c2])
        m1 = both.amin(dim=0)
        m2 = torch.where(both > m1, both, R).amin(dim=0)
    ans = torch.where(m1 >= R, -1, torch.where(m2 >= R, R - 1, m2 - 1))
    rs = raymarch.range_samples(args[0].dtype, lo.device)
    ranges = torch.where(ans >= 0, rs[ans.clamp(min=0)],
                         torch.full_like(args[1], raymarch.LASER_MAX_RANGE))
    return ranges, outside, hits, tested


def band_work(args, out, envs_per_chunk=16):
    """What K2 needs to do on these inputs, per launch: ``(warp_screens,
    lane_screens, samples)``.  Usable sources are every disc but the host's
    own and the invalid or off-map ones, and every static cell on the map;
    each warp of 32 beams screens them against its wedge, each beam screens
    those its warp keeps, and tests the band samples of the crossing ones up
    to its second hit (or to the last sample with fewer than two hits, given
    its ranges ``out``).  Counted a chunk of envs at a time."""
    pos_e, cos_a, *_rest = args
    A, L = args[6].shape[1], cos_a.shape[-1]
    ans = torch.round(out.double() / raymarch.LASER_RANGE_RESOLUTION).long()
    second = (out < raymarch.LASER_MAX_RANGE) & (ans < R - 1)
    last = torch.where(second, ans + 1, R - 1)[:, :, None, :]          # [E, Ae, 1, L]
    warp_screens = lane_screens = samples = 0.0
    for e in range(0, pos_e.shape[0], envs_per_chunk):
        chunk = tuple(x[e:e + envs_per_chunk] for x in args[:9]) + args[9:]
        src_j, _src_i, _r_out, own, _bj, _bi = _sources(chunk)
        usable = ~torch.isnan(src_j)                  # static cells on the map
        usable[:, :A] = chunk[6] != sensors._NO_DISC_ROW
        usable = usable[:, None, :] & ~own                                # [e, Ae, S]
        keep = wedge_keep(chunk)
        if keep is None:
            lane_screens += float(usable.sum()) * L
        else:
            warp_screens += float(usable.sum()) * L / 32
            lane_screens += float((usable[..., None] & keep).sum())
        lo, hi, cross = bands(chunk)
        per = torch.clamp(torch.minimum(hi, last[e:e + envs_per_chunk]) - lo + 1, min=0)
        samples += float(torch.where(cross, per, 0).sum())
    return warp_screens, lane_screens, samples


# ------------------------------------------------------------------ the cases

def _cfg(dtype):
    return EnvConfig(dtype=dtype, use_static_map=True, map_x_width=10.0, map_y_width=10.0,
                     laserscan_length=64)


def _cells(cfg, map_name, pad):
    static = grid.load_static_map(cfg, None if map_name is None else grid.world_map_path(map_name))
    return grid.occupied_cell_list(static, int(static.sum()) + pad)


def _beam_table(cfg):
    np_dtype = np.float32 if cfg.dtype == "float32" else np.float64
    return np.linspace(-np.pi / 2, np.pi / 2, cfg.laserscan_length).astype(np_dtype)


def _random(cfg, rng, E, A):
    pos = rng.uniform(-4.8, 4.8, (E, A, 2))
    pos[0, 0] = [5.3, 0.0]                                   # off the map
    pos[-1, 1] = [0.0, -5.2]
    radius = rng.uniform(0.15, 0.6, (E, A))
    heading = rng.uniform(-np.pi, np.pi, (E, A))
    return pos, radius, heading, rng.rand(E, A) > 0.15


def _tangent(cfg, rng, E, A):
    """Host 0 of each env sees every other disc on one beam that passes its
    cell centre at the inflated radius, the true radius, the true radius plus
    a cell's reach, or just inside the inflated radius."""
    cell = cfg.map_grid_cell_size
    oi, oj = grid.map_origin(cfg)
    angles = _beam_table(cfg)
    pos = rng.uniform(-4.0, 4.0, (E, A, 2))
    radius = np.full((E, A), 0.3)
    heading = rng.uniform(-np.pi, np.pi, (E, A))
    for e in range(E):
        p0 = pos[e, 0] = rng.uniform(-2.5, 2.5, 2)
        bj, bi = oj + p0[0] / cell, oi - p0[1] / cell
        for a in range(1, A):
            theta = float(angles[rng.randint(len(angles))] + angles.dtype.type(heading[e, 0]))
            c, s = math.cos(theta), math.sin(theta)
            d, b = rng.uniform(0.6, 5.0), rng.uniform(2.5, 6.0) * cell * rng.choice([-1, 1])
            gj = math.floor(oj + (p0[0] + d * c - b * s) / cell)
            gi = math.floor(oi - (p0[1] + d * s + b * c) / cell)
            pos[e, a] = [(gj + 0.5 - oj) * cell, (oi - gi - 0.5) * cell]   # the cell centre
            relj, reli = gj + 0.5 - bj, gi + 0.5 - bi
            t_c = relj * c - reli * s
            gap = math.sqrt(max(relj * relj + reli * reli - t_c * t_c, 0.0))   # cells
            reach = (SLACK, 0.0, math.sqrt(2.0) / 2, SLACK - 1e-6)[a % 4]
            radius[e, a] = (gap - reach) * cell
    return pos, radius, heading, np.ones((E, A), bool)


def _cell_boundary(cfg, rng, E, A):
    """Hosts and discs on cell corners (multiples of 0.5 m); each host's
    heading turns one beam onto an axis, exactly along +x for a quarter."""
    angles = _beam_table(cfg)
    pos = rng.randint(-8, 9, (E, A, 2)) * 0.5
    radius = rng.choice([0.1, 0.2, 0.25, 0.3, 0.5], (E, A))
    beam = rng.randint(len(angles), size=(E, A))
    turn = rng.choice([0.0, np.pi / 2, np.pi, -np.pi / 2], (E, A))
    heading = np.where(turn == 0.0, -angles[beam].astype(np.float64), turn - angles[beam])
    return pos, radius, heading, np.ones((E, A), bool)


def _map_edge(cfg, rng, E, A):
    """Discs and hosts within 0.45 m of the map's edge, on either side."""
    half = cfg.map_x_width / 2
    side = rng.randint(4, size=(E, A))
    along = rng.uniform(-half - 0.3, half + 0.3, (E, A))
    depth = half - rng.uniform(-0.45, 0.45, (E, A))
    x = np.select([side == 0, side == 1, side == 2], [depth, -depth, along], along)
    y = np.select([side == 0, side == 1, side == 2], [along, along, depth], -depth)
    pos = np.stack([x, y], -1)
    pos[:, -2:] = rng.uniform(-3.0, 3.0, (E, 2, 2))          # two agents inside
    radius = rng.uniform(0.2, 0.5, (E, A))
    heading = rng.uniform(-np.pi, np.pi, (E, A))
    return pos, radius, heading, rng.rand(E, A) > 0.1


def _host_inside_disc(cfg, rng, E, A):
    """Agent 0 inside agent 1's disc, agent 2 a copy of agent 0 (the same
    cell and radius), agent 3's disc inside agent 0's."""
    pos = rng.uniform(-3.0, 3.0, (E, A, 2))
    radius = rng.uniform(0.2, 0.4, (E, A))
    ang = rng.uniform(0, 2 * np.pi, E)
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1)
    pos[:, 1] = pos[:, 0] + dirs * rng.uniform(0.05, 0.3, (E, 1))
    radius[:, 1] = 0.55
    pos[:, 2], radius[:, 2] = pos[:, 0], radius[:, 0]
    pos[:, 3] = pos[:, 0] - dirs * 0.05
    radius[:, 3] = 0.1
    heading = rng.uniform(-np.pi, np.pi, (E, A))
    return pos, radius, heading, np.ones((E, A), bool)


# name -> (inputs, envs, agents, map, padding rows)
CASES = {
    "random": (_random, 3, 20, None, 5),
    "tangent": (_tangent, 3, 20, None, 0),
    "cell_boundary": (_cell_boundary, 4, 5, None, 0),
    "map_edge": (_map_edge, 4, 8, None, 0),
    "host_inside_disc": (_host_inside_disc, 4, 5, None, 0),
    "map_002": (_random, 2, 20, "002", 16),
    "map_002_a40": (_random, 1, 40, "002", 16),
}


def build_case(name, dtype, device):
    """``(cfg, state, static_cells)`` of one seeded case (10 x 10 m map, 64
    beams) on ``device``."""
    make_inputs, E, A, map_name, pad = CASES[name]
    cfg = _cfg(dtype)
    rng = np.random.RandomState(sorted(CASES).index(name))
    pos, radius, heading, valid = make_inputs(cfg, rng, E, A)
    state = init_state(cfg, pos, -pos, radius, np.ones((E, A)), heading=heading, valid=valid,
                       device=device)
    cells = torch.as_tensor(_cells(cfg, map_name, pad), device=device)
    return cfg, state, cells


# ------------------------------------------------------------------ the tests

@functools.lru_cache(maxsize=None)
def _run(name, dtype):
    cfg, state, cells = build_case(name, dtype, "cpu")
    args = raymarch_args(cfg, state, cells)
    ranges, outside, hits, tested = band_march(args)
    return ranges, outside, hits, tested, raymarch.raymarch_plain(*args), args


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(CASES))
def test_brute_force_hits_lie_in_their_bands(name, dtype):
    _ranges, outside, hits, _tested, _plain, _args = _run(name, dtype)
    assert hits > 0
    assert outside == 0, f"{outside} of {hits} brute-force hits outside their band"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(CASES))
def test_band_march_equals_plain(name, dtype):
    ranges, _outside, _hits, tested, plain, args = _run(name, dtype)
    itype = torch.int32 if dtype == "float32" else torch.int64
    assert ranges.dtype == plain.dtype and torch.equal(ranges.view(itype), plain.view(itype))
    assert (plain < raymarch.LASER_MAX_RANGE).sum() > 20
    # the march tests a small part of what the brute force would
    A, S = args[6].shape[1], args[9].shape[0]
    assert tested < 0.1 * plain.numel() * R * (A + S)


@pytest.mark.parametrize("name", ["random", "map_002"])
def test_band_work_counts_what_the_march_needs(name):
    """``band_work`` (K2's bound in ``chip_smoke.py``) counts each crossing
    band up to the beam's second hit: at most one sample a crossing more than
    the march tests, in chunks of envs as at once."""
    ranges, _outside, _hits, tested, _plain, args = _run(name, "float32")
    warp_screens, lane_screens, samples = band_work(args, ranges, envs_per_chunk=1)
    assert (warp_screens, lane_screens, samples) == band_work(args, ranges)
    crossings = int(bands(args)[2].sum())
    assert 0 < samples <= tested + crossings
    A, S = args[6].shape[1], int((args[9][:, 0] >= 0).sum())
    assert 0 < lane_screens < 32 * warp_screens <= ranges.numel() * (A - 1 + S)
