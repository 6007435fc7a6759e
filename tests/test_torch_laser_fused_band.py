"""K3's design (``csrc/laser_fused.cu``) modelled in plain PyTorch and held
against ``ops/laser_fused.py:beam_compacted_plain`` on the CPU.

K3 screens each source of a beam block (an agent disc, or a static occupied
cell) by its slack-inflated analytic band along the beam, keeps the first
``Cs`` crossing sources in source order, flags the beam when a further one
crosses, and runs the exact cell test on a window from each kept source's
entry.  The kernel does that with less work than the definition, and this
file models its algorithm in the kernel's order of operations:

* each warp of 32 beams first drops the sources whose inflated disc, widened
  by the rounding margins of :func:`wedge_radius`, misses the wedge between
  its first and last beam, or lies beyond the last sample;
* each beam screens the survivors in ascending source order, as the
  definition does, and stops once it has counted ``Cs + 1`` crossings;
* a kept source's window starts where the definition's does, at
  ``k0 = clip(floor(t_lo / res) - 1, 0, R)``, and ends at the band's end
  ``min(k0 + Wn - 1, floor(t_hi / res) + 1, R - 1)``, or sooner at the
  beam's current second hit ``m2``.

On seeded edge cases, in float32 and float64, it checks that every window
hit of every kept slot lies inside its band, that the model equals
``beam_compacted_plain`` bitwise (ranges and slot-overflow flags), and that
the check sees a wedge margin that drops the disc's radius.  The cases:
random states; beams tangent to the inflated and to the true radius; hosts
and discs on cell corners (with 100 beams, so the warps skip the
pre-screen); map edges and off-map discs (and the ``1e7`` sentinel of empty
candidate slots); a host inside another disc, and the host's own disc among
the sources; ``Cs = 1``; map 002 with padding rows, on both routes.
``chip_smoke.py`` runs the CUDA kernel on the same cases
(:func:`build_case`, :func:`fused_args`) and counts K3's work with
:func:`band_work`, so this module imports neither JAX nor anything that
``tests/conftest.py`` sets up.
"""

import functools
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig, init_state
from gym_collision_avoidance_torch.core.maths import sqrt_rn
from gym_collision_avoidance_torch.obs import sensors
from gym_collision_avoidance_torch.ops import laser_fused

R = laser_fused.LASER_NUM_RANGE_SAMPLES
# obs/sensors.py:_WINDOW_CELL_SLACK: r_out = (sqrt(rsq) + SLACK) * cell
SLACK = math.sqrt(2.0) + 0.05


def _raymarch_band():
    """``tests/test_torch_raymarch_band.py``, for its case generators."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_raymarch_band.py")
    spec = importlib.util.spec_from_file_location("raymarch_band_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


K2_CASES = _raymarch_band()


# ------------------------------------------------------------------ the model

def fused_args(cfg, state, cells):
    """The arguments the beam-compacted route of ``laserscan_sparse`` hands
    to K3 (the route runs on, with the plain version's result)."""
    calls = []
    orig = laser_fused.beam_compacted

    def spy(*args):
        calls.append(args)
        return laser_fused.beam_compacted_plain(*args)

    laser_fused.beam_compacted = spy
    try:
        sensors.laserscan_sparse(state, cfg, cells)
    finally:
        laser_fused.beam_compacted = orig
    assert len(calls) == 1
    return calls[0]


def margin_coefficients(dtype):
    """``(a, b)`` of the wedge margin ``a * far + b * far**2 / r_out``: 8 and
    16 times sqrt(u) and u, u the unit roundoff, as powers of two
    (csrc/laser_fused.cu: kMarginSqrt, kMarginLin)."""
    return (2.0 ** -9, 2.0 ** -20) if dtype == torch.float32 else (2.0 ** -23, 2.0 ** -49)


def wedge_radius(ro2, span_ok, t_max, with_r_out=True):
    """The radius ``w`` ``[..., S]`` a source's disc is widened to for the
    pre-screen, as the kernel stages it: ``r_out`` plus the rounding
    margins, ``inf`` where that is not a number, -1 for a source the
    definition never screens (``span_ok`` false).  ``with_r_out=False``
    leaves the disc's radius out (too tight, for the tests)."""
    a, b = margin_coefficients(ro2.dtype)
    r_out = torch.where(ro2 > 0, sqrt_rn(torch.clamp(ro2, min=0.0)), 0.0)
    far = t_max + r_out
    w = a * far + b * (far * far) / r_out
    if with_r_out:
        w = r_out + w
    w = torch.where(w >= 0, w, math.inf)
    return torch.where(span_ok, w, -1.0)


def wedge_keep(args, with_r_out=True):
    """``[E, Ae, B, S, Lb]``: the sources each warp keeps, repeated on its 32
    beams.  A source is dropped when its widened disc lies wholly clockwise
    of the warp's first beam's line, wholly counter-clockwise of its last's,
    or beyond ``t_max``.  When 32 does not divide ``Lb`` the kernel skips the
    pre-screen and keeps every source with ``span_ok``."""
    cos_a, sin_a, relx, rely, rel2, ro2, span_ok, cfg = args[4:6] + args[9:15]
    t_max = laser_fused.consts(cfg, relx.dtype)[-1]
    E, Ae, L = cos_a.shape
    B, S = relx.shape[2:]
    Lb = L // B
    w = wedge_radius(ro2, span_ok, t_max, with_r_out)                    # [E, Ae, B, S]
    if Lb % 32:
        return (w >= 0)[..., None].expand(E, Ae, B, S, Lb)
    c = cos_a.reshape(E, Ae, B, 1, Lb // 32, 32)
    s = sin_a.reshape(E, Ae, B, 1, Lb // 32, 32)
    px, py, p2, ww = (v[..., None] for v in (relx, rely, rel2, w))      # [E, Ae, B, S, 1]
    side_cw = c[..., 0] * py - s[..., 0] * px                            # [E, Ae, B, S, Lb/32]
    side_ccw = c[..., 31] * py - s[..., 31] * px
    far = t_max + ww
    near = (ww >= 0) & (p2 <= far * far) & ~(side_cw < -ww) & ~(side_ccw > ww)
    return near.repeat_interleave(32, dim=-1)


def screen(args):
    """``(cross, t_lo, t_hi)`` ``[E, Ae, B, S, Lb]``: the definition's screen
    of every source on every beam, in its rounded arithmetic."""
    cos_a, sin_a, relx, rely, rel2, ro2, span_ok, cfg = args[4:6] + args[9:15]
    t_max = laser_fused.consts(cfg, relx.dtype)[-1]
    E, Ae, L = cos_a.shape
    B = relx.shape[2]
    c = cos_a.reshape(E, Ae, B, 1, L // B)
    s = sin_a.reshape(E, Ae, B, 1, L // B)
    t_c = relx[..., None] * c + rely[..., None] * s
    disc = ro2[..., None] - (rel2[..., None] - t_c * t_c)
    half = sqrt_rn(torch.clamp(disc, min=0.0))
    t_lo, t_hi = t_c - half, t_c + half
    cross = (disc > 0.0) & (t_hi >= 0.0) & (t_lo <= t_max) & span_ok[..., None]
    return cross, t_lo, t_hi


def window_band(t_lo, t_hi, inv_res, Wn, end_pad=1):
    """``(k0, k_end)``: the definition's window start and the band's end
    (``end_pad`` samples past ``floor(t_hi / res)``; the kernel's is 1)."""
    k0 = torch.clamp(torch.floor(t_lo * inv_res).to(torch.int32) - 1, 0, R)
    k_end = torch.clamp(torch.floor(t_hi * inv_res) + end_pad, max=R - 1.0).to(torch.int32)
    return k0, torch.minimum(k0 + Wn - 1, k_end)


def _sample_cells(args):
    """``(ii, jj, free)`` ``[E, Ae, B, Lb, R]``: every range sample's cell, as
    the definition computes it, and whether it is on the map and outside the
    host's own disc."""
    (pos_e, gi_e, gj_e, rsq_e, cos_a, sin_a, *_rest, cfg, _Wn, _Cs) = args
    dtype = pos_e.dtype
    H, W, oi, oj, inv_cell, res, _inv_res, _t_max = laser_fused.consts(cfg, dtype)
    E, Ae, L = cos_a.shape
    B = args[6].shape[2]
    c = cos_a.reshape(E, Ae, B, L // B, 1)
    s = sin_a.reshape(E, Ae, B, L // B, 1)
    rr = torch.arange(R, device=pos_e.device).to(dtype) * res
    px = pos_e[..., 0][:, :, None, None, None] + rr * c
    py = pos_e[..., 1][:, :, None, None, None] + rr * s
    ii = torch.floor(oi - py * inv_cell).to(torch.int32)
    jj = torch.floor(oj + px * inv_cell).to(torch.int32)
    dei = ii - gi_e[:, :, None, None, None]
    dej = jj - gj_e[:, :, None, None, None]
    in_ego = (dei * dei + dej * dej).to(dtype) < rsq_e[:, :, None, None, None]
    free = (ii >= 0) & (ii < H) & (jj >= 0) & (jj < W) & ~in_ego
    return ii, jj, free


def band_march(args, end_pad=1, with_r_out=True):
    """The kernel's algorithm: for each source in order, the lanes whose warp
    kept it and that have not yet counted ``Cs + 1`` crossings screen it; a
    crossing source among the first ``Cs`` is tested on its band below the
    current second hit, and the hits merge into the two smallest distinct
    indices.  Returns ``(ranges, overflow, outside, hits, tested)``:
    ``outside`` counts the kept slots' window hits (the definition's ``Wn``
    samples) outside their band, ``hits`` all of them, ``tested`` the
    samples the march tests."""
    gi_d, gj_d, irsq_d, cfg, Wn, Cs = args[6], args[7], args[8], args[14], args[15], args[16]
    inv_res = laser_fused.consts(cfg, args[0].dtype)[6]
    S = gi_d.shape[3]
    keep = wedge_keep(args, with_r_out)
    cross_all, t_lo, t_hi = screen(args)
    ii, jj, free = _sample_cells(args)
    k = torch.arange(R, device=ii.device)
    count = torch.zeros(ii.shape[:-1], dtype=torch.int64, device=ii.device)  # [E, Ae, B, Lb]
    m1 = torch.full_like(count, R)
    m2 = m1.clone()
    outside = hits = tested = 0
    for q in range(S):
        cross = keep[:, :, :, q] & cross_all[:, :, :, q] & (count <= Cs)
        kept = (cross & (count < Cs))[..., None]
        count = count + cross
        k0, k_end = window_band(t_lo[:, :, :, q], t_hi[:, :, :, q], inv_res, Wn, end_pad)
        k0, k_end = k0[..., None], k_end[..., None]
        di = ii - gi_d[:, :, :, q, None, None]
        dj = jj - gj_d[:, :, :, q, None, None]
        hit = free & (di * di + dj * dj < irsq_d[:, :, :, q, None, None])
        window = kept & (k >= k0) & (k < k0 + Wn)
        band = kept & (k >= k0) & (k <= k_end)
        outside += int((hit & window & ~band).sum())
        hits += int((hit & window).sum())
        live = band & (k < m2[..., None])
        tested += int(live.sum())
        idx = torch.where(hit & live, k, R)
        c1 = idx.amin(dim=-1)
        c2 = torch.where(idx > c1[..., None], idx, R).amin(dim=-1)
        both = torch.stack([m1, m2, c1, c2])
        m1 = both.amin(dim=0)
        m2 = torch.where(both > m1, both, R).amin(dim=0)
    E, Ae, L = args[4].shape
    ranges = laser_fused.ranges_from_hits(torch.stack([m1, m2], dim=-2), args[0].dtype)
    return ranges.reshape(E, Ae, L), (count > Cs).reshape(E, Ae, L), outside, hits, tested


def band_work(args, out, envs_per_chunk=16):
    """What K3 needs to do on these inputs, per launch: ``(warp_screens,
    lane_screens, samples)``.  A warp screens every source with ``span_ok``
    of each chunk of 32 sources against its wedge, until all its beams have
    counted ``Cs + 1`` crossings; a beam screens the sources its warp keeps
    up to its ``Cs + 1``-th crossing, and tests the band samples of its
    first ``Cs`` up to its second hit (or to the last sample with fewer than
    two hits, given its ranges ``out``).  Counted a chunk of envs at a
    time."""
    cos_a, span_ok, cfg, Wn, Cs = args[4], args[13], args[14], args[15], args[16]
    inv_res = laser_fused.consts(cfg, cos_a.dtype)[6]
    E, Ae, L = cos_a.shape
    B, S = span_ok.shape[2:]
    Lb = L // B
    res = laser_fused.LASER_RANGE_RESOLUTION
    ans = torch.round(out.double() / res).long()
    second = (out < laser_fused.LASER_MAX_RANGE) & (ans < R - 1)
    last = torch.where(second, ans + 1, R - 1).reshape(E, Ae, B, 1, Lb)
    warp_screens = lane_screens = samples = 0.0
    for e in range(0, E, envs_per_chunk):
        chunk = tuple(x[e:e + envs_per_chunk] for x in args[:14]) + args[14:]
        cross, t_lo, t_hi = screen(chunk)
        before = torch.cumsum(cross, dim=3) - cross.long()   # crossings before each source
        screened = wedge_keep(chunk) & (before <= Cs)
        lane_screens += float(screened.sum())
        if Lb % 32 == 0:
            # chunk j of a warp runs while some beam has counted at most Cs
            # crossings before source 32 j
            starts = before[:, :, :, ::32].reshape(*before.shape[:3], -1, Lb // 32, 32)
            runs = (starts <= Cs).any(dim=-1)                           # [e, Ae, B, J, Lb/32]
            ok = torch.nn.functional.pad(span_ok[e:e + envs_per_chunk].long(), (0, -S % 32))
            per_chunk = ok.reshape(*ok.shape[:3], -1, 32).sum(dim=-1)   # [e, Ae, B, J]
            warp_screens += float((runs * per_chunk[..., None]).sum())
        k0, k_end = window_band(t_lo, t_hi, inv_res, Wn)
        per = torch.clamp(torch.minimum(k_end, last[e:e + envs_per_chunk]) - k0 + 1, min=0)
        samples += float(torch.where(cross & (before < Cs), per, 0).sum())
    return warp_screens, lane_screens, samples


# ------------------------------------------------------------------ the cases

def _tangent(cfg, rng, E, A):
    """Host 0 of each env sees every other disc on one of its beams, which
    passes the disc's centre at the inflated radius r_out, at the true
    radius, or just inside r_out."""
    cell = cfg.map_grid_cell_size
    angles = K2_CASES._beam_table(cfg)
    pos = rng.uniform(-4.0, 4.0, (E, A, 2))
    radius = np.full((E, A), 0.3)
    heading = rng.uniform(-np.pi, np.pi, (E, A))
    for e in range(E):
        p0 = pos[e, 0] = rng.uniform(-2.5, 2.5, 2)
        for a in range(1, A):
            theta = float(angles[rng.randint(len(angles))] + angles.dtype.type(heading[e, 0]))
            c, s = math.cos(theta), math.sin(theta)
            d, b = rng.uniform(0.6, 5.6), rng.uniform(0.25, 0.6)
            side = rng.choice([-1.0, 1.0])
            pos[e, a] = p0 + d * np.array([c, s]) + side * b * np.array([-s, c])
            radius[e, a] = b - (SLACK * cell, 0.0, SLACK * cell - 1e-6)[a % 3]
    return pos, radius, heading, np.ones((E, A), bool)


WEDGE = dict(laserscan_num_candidate_discs=9)
# name -> (inputs, envs, agents, map, padding rows, beams, route)
CASES = {
    "random": (K2_CASES._random, 3, 20, None, 5, 256, WEDGE),
    "tangent": (_tangent, 3, 20, None, 0, 256, {}),
    "cell_boundary": (K2_CASES._cell_boundary, 4, 5, None, 0, 100, {}),
    "map_edge": (K2_CASES._map_edge, 4, 8, None, 0, 256, dict(laserscan_num_candidate_discs=4)),
    "host_inside_disc": (K2_CASES._host_inside_disc, 4, 5, None, 0, 256, {}),
    "slots_overflow": (K2_CASES._random, 2, 20, "002", 16, 256,
                       dict(WEDGE, laserscan_beam_slots=1)),
    "map_002": (K2_CASES._random, 2, 20, "002", 16, 256, WEDGE),
    "b1_map_002": (K2_CASES._random, 2, 20, "002", 16, 128, {}),
}


def build_case(name, dtype, device):
    """``(cfg, state, static_cells)`` of one seeded case (10 x 10 m map, the
    beam-compacted route: 12-sample windows, 4 beam slots unless the case
    says otherwise) on ``device``."""
    make_inputs, E, A, map_name, pad, L, route = CASES[name]
    kw = dict(dtype=dtype, use_static_map=True, map_x_width=10.0, map_y_width=10.0,
              laserscan_length=L, laserscan_entry_window=12, laserscan_beam_slots=4)
    cfg = EnvConfig(**{**kw, **route})
    rng = np.random.RandomState(sorted(CASES).index(name))
    pos, radius, heading, valid = make_inputs(cfg, rng, E, A)
    state = init_state(cfg, pos, -pos, radius, np.ones((E, A)), heading=heading, valid=valid,
                       device=device)
    cells = torch.as_tensor(K2_CASES._cells(cfg, map_name, pad), device=device)
    return cfg, state, cells


# ------------------------------------------------------------------ the tests

@functools.lru_cache(maxsize=None)
def _args(name, dtype):
    return fused_args(*build_case(name, dtype, "cpu"))


@functools.lru_cache(maxsize=None)
def _run(name, dtype):
    args = _args(name, dtype)
    return band_march(args), laser_fused.beam_compacted_plain(*args)


def _bitwise(a, b):
    itype = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(itype), b.view(itype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(CASES))
def test_window_hits_lie_in_their_bands(name, dtype):
    (_ranges, _ovf, outside, hits, _tested), _plain = _run(name, dtype)
    assert hits > 0
    assert outside == 0, f"{outside} of {hits} window hits outside their band"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(CASES))
def test_band_march_equals_plain(name, dtype):
    (ranges, ovf, _outside, _hits, tested), (plain, plain_ovf) = _run(name, dtype)
    assert _bitwise(ranges, plain)
    assert torch.equal(ovf, plain_ovf)
    assert (plain < laser_fused.LASER_MAX_RANGE).sum() > 20
    if name == "slots_overflow":
        assert plain_ovf.any()
    # the march tests fewer samples than the definition's windows
    args = _args(name, dtype)
    cross = screen(args)[0]
    kept = cross & (torch.cumsum(cross, dim=3) <= args[16])
    assert tested < int(kept.sum()) * args[15]


def test_the_wedge_screen_drops_no_crossing_source():
    """Every source that crosses a beam by the definition's rounded screen
    survives its warp's pre-screen, on every case and in both dtypes."""
    for name in CASES:
        for dtype in ("float32", "float64"):
            args = _args(name, dtype)
            cross = screen(args)[0]
            assert not (cross & ~wedge_keep(args)).any(), (name, dtype)


def test_a_wedge_margin_without_r_out_is_seen():
    """The checks see a pre-screen that is too tight: without the disc's
    radius in its margin it drops crossing sources, and the march then
    differs from the definition."""
    args = _args("random", "float32")
    cross = screen(args)[0]
    assert (cross & ~wedge_keep(args, with_r_out=False)).any()
    ranges, ovf, *_ = band_march(args, with_r_out=False)
    plain, plain_ovf = laser_fused.beam_compacted_plain(*args)
    assert not (_bitwise(ranges, plain) and torch.equal(ovf, plain_ovf))


def test_a_band_end_one_sample_short_is_seen():
    """The checks see a band end that is too tight: one sample short of the
    kernel's (``floor(t_hi / res) - 1`` instead of ``+ 1``), some window
    hits fall outside it."""
    args = _args("random", "float32")
    outside = band_march(args, end_pad=-1)[2]
    assert outside > 0


@pytest.mark.parametrize("name", ["random", "map_002", "cell_boundary"])
def test_band_work_counts_what_the_march_needs(name):
    """``band_work`` (K3's bound in ``chip_smoke.py``) counts each kept
    slot's band up to the beam's second hit: at most one sample a slot more
    than the march tests, the same in chunks of one env as at once."""
    args = _args(name, "float32")
    (ranges, _ovf, _outside, _hits, tested), _plain = _run(name, "float32")
    work = band_work(args, ranges)
    assert work == band_work(args, ranges, envs_per_chunk=1)
    warp_screens, lane_screens, samples = work
    cross = screen(args)[0]
    kept = int((cross & (torch.cumsum(cross, dim=3) <= args[16])).sum())
    assert 0 < samples <= tested + kept
    beams_x_usable = float(args[13].sum()) * args[4].shape[-1] / args[6].shape[2]
    assert 0 < lane_screens <= beams_x_usable
    if args[4].shape[-1] // args[6].shape[2] % 32:
        assert warp_screens == 0
    else:
        assert 0 < warp_screens <= beams_x_usable / 32 and lane_screens < beams_x_usable
