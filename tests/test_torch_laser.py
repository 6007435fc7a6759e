"""The port's laserscan sensors against the JAX package's, on the CPU.

* The range table is bitwise JAX's; the beam-angle table is numpy's
  float64 ``linspace`` cast to the dtype, bitwise JAX's ``jnp.linspace``
  table in float32.  In float64 ``jnp.linspace`` is off numpy's table on
  76 of 128 and 314 of 512 entries, by at most 1.25 ulp of pi/2 (2.8e-16
  rad; near zero that is many ulps of the entry itself).
* Quotients by a configured constant are products with the reciprocal
  rounded to the dtype, as XLA compiles the JAX package's divisions.
* ``laserscan`` (dense) and every route of ``laserscan_sparse`` (full,
  wedge-culled, windowed, beam-compacted, and their combinations), with and
  without static cells and with an ego subset, equal the jitted
  ``jax.vmap`` of the JAX functions bitwise in float64, ranges and
  overflow flags.  An ulp of angle or of a trig value moves a sample by
  about 1e-15 m, far from any cell boundary in these seeded cases.
* The port's plain K2 and K3 against the Pallas kernels run in interpret
  mode, in float32: overflow flags exact, ranges equal on all but at most
  1e-4 of the beams (XLA's and PyTorch's float32 sin/cos differ by ulps).
* The diagnostics and the occupancy grid equal JAX's exactly, and a radius
  above 0.79 m shows K3's documented deviation from the XLA twin.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import ops
from gym_collision_avoidance_torch.maps import grid as tgrid
from gym_collision_avoidance_torch.obs import sensors as tsens
from gym_collision_avoidance_torch.ops import laser_fused, raymarch as traymarch
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu.maps import grid as jgrid
from gym_collision_avoidance_tpu.obs import sensors as jsens

ROUTES = {
    "full": {},
    "wedge": dict(laserscan_num_candidate_discs=5),
    "window": dict(laserscan_entry_window=12),
    "beam_slots": dict(laserscan_entry_window=12, laserscan_beam_slots=4),
    "wedge_window": dict(laserscan_num_candidate_discs=5, laserscan_entry_window=12),
    "wedge_beam_slots": dict(laserscan_num_candidate_discs=5, laserscan_entry_window=12,
                             laserscan_beam_slots=4),
}


def _cfgs(dtype, L=128, width=10.0, **route):
    kw = dict(dtype=dtype, use_static_map=True, map_x_width=width, map_y_width=width,
              laserscan_length=L, **route)
    return JCfg(**kw), TCfg(**kw)


def _cells(cfg, with_map, pad=7):
    static = jgrid.load_static_map(cfg, jgrid.world_map_path("002") if with_map else None)
    n = int(static.sum())
    return static, jgrid.occupied_cell_list(static, n + pad if with_map else None)


def _states(cfg, seed, E=3, A=8, spread=3.5, radius=(0.2, 0.5)):
    """Seeded batched JAX states: agents close enough to see each other,
    some invalid, one off the map."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, (E, A, 2))
    pos[0, 0] = [cfg.map_x_width / 2 + 0.5, 0.0]
    goal = rng.uniform(-4, 4, (E, A, 2))
    rad = rng.uniform(*radius, (E, A))
    valid = rng.rand(E, A) > 0.15
    heading = rng.uniform(-np.pi, np.pi, (E, A))
    return tp.jax_batched_init(cfg, pos, goal, rad, np.ones((E, A)), heading=heading,
                               valid=valid)


def _jax_sparse_fn(jcfg, cells, ego_idx):
    return jax.jit(jax.vmap(lambda s: jsens.laserscan_sparse(
        s, jcfg, jnp.asarray(cells), ego_idx=ego_idx, return_overflow=True)))


def _jax_sparse(jcfg, cells, jst, ego_idx):
    return _jax_sparse_fn(jcfg, cells, ego_idx)(jst)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_range_and_angle_tables(dtype):
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref = np.asarray(jsens._range_samples(jdt))
    got = traymarch.range_samples(tdt, "cpu").numpy()
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    for L in (128, 512):
        got = tsens.beam_angles(L, tdt, "cpu").numpy()
        jnp_table = np.asarray(jnp.linspace(jsens.LASER_MIN_ANGLE, jsens.LASER_MAX_ANGLE,
                                            L).astype(jdt))
        np_table = np.linspace(-np.pi / 2, np.pi / 2, L).astype(dtype)
        assert got.tobytes() == np_table.tobytes()
        if dtype == "float32":
            assert got.tobytes() == jnp_table.tobytes()
        else:
            # jnp.linspace is off numpy's table on some entries, by at most
            # about an ulp of the table's largest entry
            diff = np.abs(got - jnp_table)
            assert diff.max() <= 2 * np.spacing(np.pi / 2) and (diff > 0).sum() > L // 4


def test_quotients_by_constants_are_reciprocal_products():
    """XLA compiles the JAX package's quotients by constants to products
    with the reciprocal; in float32 they differ from the true quotient on
    rare inputs, and the port gives the product."""
    jcfg, tcfg = _cfgs("float32", width=20.0)
    ten = np.float32(10.0)
    assert tgrid.reciprocal(0.1, torch.float32) == 10.0
    # (radius / cell)**2 of the disc tests
    r = np.array([[0.45709074, 0.58493507]], np.float32)
    assert ((r / np.float32(0.1)) ** 2 != (r * ten) ** 2).all()
    ref = np.asarray(jax.jit(lambda r: (r / jcfg.map_grid_cell_size) ** 2)(r))
    got = tgrid.radius_cells_sq(torch.tensor(r), tcfg).numpy()
    assert got.tobytes() == ref.tobytes() == ((r * ten) ** 2).tobytes()
    # floor(t / res), the window starts
    t = np.array([3.6999998, 1.3], np.float32)
    assert (np.floor(t / np.float32(0.1)) != np.floor(t * ten)).all()
    res = jnp.asarray(0.1, jnp.float32)
    ref = np.asarray(jax.jit(lambda t: jnp.floor(t / res))(t))
    got = torch.floor(torch.tensor(t) * laser_fused.consts(tcfg, torch.float32)[6]).numpy()
    assert got.tobytes() == ref.tobytes() == np.floor(t * ten).tobytes()
    # no laser route divides by a constant in its compiled HLO; the one
    # divide left is the wedge screen's rhit / max(d, 1e-9)
    jst = _states(jcfg, 0, E=1)
    for route in ("full", "window", "wedge_beam_slots"):
        jc, _ = _cfgs("float32", **ROUTES[route])
        hlo = jax.jit(jax.vmap(lambda s: jsens.laserscan_sparse(
            s, jc, jnp.zeros((0, 2), jnp.int32), return_overflow=True))).lower(
                jst).compile().as_text()
        assert hlo.count(" divide(") == ("wedge" in route), route
    # XLA:CPU also contracts world_to_map's oi - y * (1 / cell) into one
    # fused multiply-add; on this input that rounds like the true quotient,
    # and the port's separately rounded product gives the next row
    y = np.float32(-3.499999)
    pos = np.array([[0.0, y]], np.float32)
    fn = jax.jit(lambda p: jgrid.world_to_map(p, jcfg, (200, 200)))
    assert " divide(" not in fn.lower(pos).compile().as_text()
    fused = np.floor(np.float32(100.0 - np.float64(y) * 10.0))
    assert int(np.asarray(fn(pos)[0])[0]) == fused == 134
    got_i = int(tgrid.world_to_map(torch.tensor(pos), tcfg, (200, 200))[0][0])
    assert got_i == np.floor(np.float32(100) - y * ten) == 135


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("with_map,ego_idx", [(False, None), (True, (1, 4, 6))])
def test_laserscan_sparse_routes_match_jax_f64(route, with_map, ego_idx):
    jcfg, tcfg = _cfgs("float64", **ROUTES[route])
    _static, cells = _cells(jcfg, with_map)
    windowed = "laserscan_entry_window" in ROUTES[route]
    run = _jax_sparse_fn(jcfg, cells, ego_idx)
    # radii up to 0.3 m fit a 12-sample window, so without static cells the
    # guard stays quiet on some envs; the wider radii trip it
    for seed, radius in ((1, (0.2, 0.5)), (2, (0.2, 0.3))):
        jst = _states(jcfg, seed, radius=radius)
        ref, ref_ovf = (np.asarray(x) for x in run(jst))
        got, ovf = tsens.laserscan_sparse(tp.to_torch(jst), tcfg, cells, ego_idx=ego_idx,
                                          return_overflow=True)
        assert got.dtype == torch.float64 and ovf.shape == (3,)
        assert got.numpy().tobytes() == ref.tobytes(), (route, seed)
        np.testing.assert_array_equal(ovf.numpy(), ref_ovf)
        assert (ref < jsens.LASER_MAX_RANGE).sum() > 50
        if windowed and seed == 2 and not with_map:
            assert not ref_ovf.all()


def test_wedge_route_over_several_beam_blocks_matches_jax():
    jcfg, tcfg = _cfgs("float64", L=256, laserscan_num_candidate_discs=4,
                       laserscan_entry_window=12, laserscan_beam_slots=3)
    _static, cells = _cells(jcfg, True)
    jst = _states(jcfg, 5, A=8, radius=(0.2, 0.3))
    ref, ref_ovf = (np.asarray(x) for x in _jax_sparse(jcfg, cells, jst, None))
    got, ovf = tsens.laserscan_sparse(tp.to_torch(jst), tcfg, cells, return_overflow=True)
    assert got.numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(ovf.numpy(), ref_ovf)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ego_idx", [None, (0, 3)])
def test_dense_laserscan_and_occupancy_grid_match_jax(dtype, ego_idx):
    jcfg, tcfg = _cfgs(dtype)
    static, cells = _cells(jcfg, True)
    jst = _states(jcfg, 3)

    def one(s):
        dyn = jgrid.stamp_agents(jnp.asarray(static), s.pos, s.radius, s.valid, jcfg)
        return (jsens.laserscan(s, jcfg, dyn, ego_idx=ego_idx),
                jsens.occupancy_grid(s, jcfg, dyn),
                jsens.laserscan_sparse(s, jcfg, jnp.asarray(cells), ego_idx=ego_idx))

    ref_dense, ref_og, ref_sparse = (np.asarray(x) for x in jax.jit(jax.vmap(one))(jst))
    st = tp.to_torch(jst)
    dyn = tgrid.stamp_agents(torch.tensor(static), st.pos, st.radius, st.valid, tcfg)
    got = tsens.laserscan(st, tcfg, dyn, ego_idx=ego_idx)
    assert got.numpy().tobytes() == ref_dense.tobytes()
    # the dense march and the sparse pass agree, as in the JAX package
    assert ref_dense.tobytes() == ref_sparse.tobytes()
    og = tsens.occupancy_grid(st, tcfg, dyn)
    np.testing.assert_array_equal(og.numpy(), ref_og)
    assert ref_og.any() and not ref_og.all()


@pytest.mark.parametrize("ego_idx", [None, (2, 5)])
def test_diagnostics_match_jax(ego_idx):
    jcfg, tcfg = _cfgs("float64")
    _static, cells = _cells(jcfg, True)
    jst = _states(jcfg, 4, E=2)
    st = tp.to_torch(jst)
    for c in (None, cells):
        ref = max(jsens.laserscan_window_span(
            jax.tree.map(lambda x: x[e], jst), jcfg,
            None if c is None else jnp.asarray(c), ego_idx) for e in range(2))
        assert tsens.laserscan_window_span(st, tcfg, c, ego_idx) == ref
    for blocks in (1, 2):
        ref = jax.jit(jax.vmap(lambda s: jsens.laserscan_wedge_candidate_counts(
            s, jcfg, ego_idx=ego_idx, num_blocks=blocks)))(jst)
        got = tsens.laserscan_wedge_candidate_counts(st, tcfg, ego_idx, blocks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _f32_states(cfg, seed, E, A, spread, radius):
    jst = _states(cfg, seed, E=E, A=A, spread=spread, radius=radius)
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, jst)


def _budget(got, ref, what):
    """f32 ranges across the two frameworks: at most 1e-4 of beams differ."""
    differ = int((got != ref).sum())
    print(f"{what}: {differ} of {ref.size} beams differ")
    assert differ <= 1e-4 * ref.size, (what, differ)


def test_plain_k2_matches_pallas_interpret(monkeypatch):
    from gym_collision_avoidance_tpu.ops import raymarch as jraymarch

    jcfg, tcfg = _cfgs("float32")
    _static, cells = _cells(jcfg, True, pad=11)
    E, A = 4, 6                          # E * A a multiple of the kernel's 8 hosts
    jst = _f32_states(jcfg, 6, E, A, 3.0, (0.2, 0.5))
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    importlib.reload(jraymarch)
    try:
        ref = np.asarray(jraymarch.laserscan_sparse_pallas(jst, jcfg, jnp.asarray(cells)))
    finally:
        monkeypatch.setattr(pl, "pallas_call", orig)
        importlib.reload(jraymarch)
    st = tp.to_torch(jst)
    before = ops.launch_counts()["raymarch"]
    got = tsens.laserscan_sparse(st, tcfg, cells).numpy()
    assert ops.launch_counts()["raymarch"] == before    # the CPU runs the plain version
    assert got.dtype == ref.dtype == np.float32
    _budget(got, ref, "K2 plain vs Pallas interpret")
    assert (ref < jsens.LASER_MAX_RANGE).sum() > 100


def test_plain_k3_matches_pallas_interpret(monkeypatch):
    kw = dict(max_num_other_agents_observed=19, agent_sorting_method="closest_last",
              laserscan_num_candidate_discs=9, laserscan_entry_window=12,
              laserscan_beam_slots=4)
    jcfg, tcfg = _cfgs("float32", L=128, width=20.0, **kw)
    _static, cells = _cells(jcfg, False)          # the benchmark's empty map
    jst = _f32_states(jcfg, 40, 1, 20, 7.0, (0.2, 0.3))
    one = jax.tree.map(lambda x: x[0], jst)
    run = jax.jit(lambda s: jsens.laserscan_sparse(s, jcfg, jnp.asarray(cells),
                                                   return_overflow=True))
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jsens, "_WBC_PALLAS", True)
    jax.clear_caches()
    try:
        ref, ref_ovf = (np.asarray(x) for x in run(one))
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    got, ovf = tsens.laserscan_sparse(tp.to_torch(jst), tcfg, cells, return_overflow=True)
    assert bool(ovf[0]) == bool(ref_ovf)
    _budget(got[0].numpy(), ref, "K3 plain vs Pallas interpret")
    assert (ref < jsens.LASER_MAX_RANGE).sum() > 100


def test_large_radius_shows_the_k3_deviation():
    """The XLA twin packs the integer radius in 6 bits: a disc above 0.79 m
    on a 0.1 m grid trips its guard and is clamped.  K3 and its plain
    version keep the radius, so with a wide enough window they still equal
    the full pass."""
    kw = dict(laserscan_entry_window=20, laserscan_beam_slots=8)
    jcfg, tcfg = _cfgs("float64", **kw)
    jfull, tfull = _cfgs("float64")
    _static, cells = _cells(jcfg, False)
    jst = _states(jcfg, 8, E=2, A=4, spread=2.5, radius=(0.85, 0.95))
    ref, ref_ovf = (np.asarray(x) for x in _jax_sparse(jcfg, cells, jst, None))
    full = np.asarray(_jax_sparse(jfull, cells, jst, None)[0])
    got, ovf = tsens.laserscan_sparse(tp.to_torch(jst), tcfg, cells, return_overflow=True)
    assert ref_ovf.all() and not ovf.any()
    assert got.numpy().tobytes() == full.tobytes()
    assert (ref != full).any()
    # at radii up to 0.79 m the two agree exactly
    jst = _states(jcfg, 8, E=2, A=4, spread=2.5, radius=(0.6, 0.79))
    ref, ref_ovf = (np.asarray(x) for x in _jax_sparse(jcfg, cells, jst, None))
    got, ovf = tsens.laserscan_sparse(tp.to_torch(jst), tcfg, cells, return_overflow=True)
    assert got.numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(ovf.numpy(), ref_ovf)


def test_beam_slot_overflow_is_flagged():
    jcfg, tcfg = _cfgs("float64", laserscan_entry_window=12, laserscan_beam_slots=1)
    _static, cells = _cells(jcfg, True)
    jst = _states(jcfg, 9, radius=(0.2, 0.3))
    ref, ref_ovf = (np.asarray(x) for x in _jax_sparse(jcfg, cells, jst, None))
    st = tp.to_torch(jst)
    got, ovf = tsens.laserscan_sparse(st, tcfg, cells, return_overflow=True)
    assert got.numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(ovf.numpy(), ref_ovf)
    assert ref_ovf.any()
