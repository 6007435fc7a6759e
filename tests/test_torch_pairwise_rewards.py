"""The reward stage of the env step in the port (``ops/pairwise.py``:
``pairwise_rewards_plain``, K1 followed by the reward chain) against the JAX
package's ``env/step.py:_compute_rewards``, ``vmap``-ed over envs, with JAX
on the CPU.  The fused CUDA kernel against the plain version is in
``test_torch_pairwise_cuda.py``.

Inputs are seeded with numpy and cover every branch of the chain: an agent
reaching its goal and one already there, exactly-touching pairs (a 3-4-5
triangle on a quarter-metre grid with radii 2 and 3, so ``dist == r_i + r_j``
in both dtypes), wall hits on map 002 through JAX's ``static_map`` route,
getting close, wiggly turns, both ends of the clip, invalid agents, an env
with a single valid agent (no valid partner) and a NaN position; A in
{2, 4, 20}.  Float64 runs under x64; float32 under ``jax.enable_x64(False)``,
where JAX's float32 step runs wholly in float32.

Tolerances: collision flags and the latched ``in_collision`` are exact.
Nearest gaps and rewards agree to 1e-14 in float64 and 1e-6 in float32 (atol),
K1's tolerances (``test_torch_pairwise.py``): XLA's CPU backend contracts
``dx*dx + dy*dy`` into FMAs in some fusions, and a reward is
``-0.1 - nearest / 2`` on getting-close rows.  A branch taken apart would
differ by far more, so the inputs keep every nearest gap more than that
tolerance away from ``getting_close_range`` and from 0 (other than the exact
touches), and each test asserts it (:func:`_assert_margins`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import ops
from gym_collision_avoidance_torch.maps import grid as tgrid
from gym_collision_avoidance_torch.ops import pairwise as tpair
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu.env import step as jstep

TOL = {"float64": 1e-14, "float32": 1e-6}
# reward settings whose clip each end reaches: time step + wiggly above the
# largest possible reward, getting close + wiggly below the smallest
CONFIGS = {
    "default": {},
    "clip_high": dict(reward_time_step=0.5, reward_wiggly_behavior=0.7,
                      wiggly_behavior_threshold=0.3),
    "clip_low": dict(reward_wiggly_behavior=-0.2, wiggly_behavior_threshold=0.3),
    # a wall penalty apart from the agent one, so an agent and a wall hit
    # at once show which of the two the chain gives
    "wall": dict(reward_collision_with_wall=-0.15),
}
MAP = dict(use_static_map=True, map_x_width=10.0, map_y_width=10.0)


def _leaves(jcfg, seed, E, A, nan=False, on_map=False):
    """Seeded ``[E, A]`` states: random flags, touching pairs in every
    fourth env, one env with a single valid agent."""
    rng = np.random.RandomState(seed)
    side = 0.8 * np.sqrt(A) + 0.8
    pos = rng.uniform(-side, side, (E, A, 2))
    radius = rng.uniform(0.2, 0.5, (E, A))
    valid = rng.rand(E, A) > 0.15
    if on_map:
        pos[:, 0] = rng.uniform(-0.6, 0.6, (E, 2))    # on or near map 002's obstacle
    # agents 0 and 1 touch in every fourth env: a 3-4-5 triangle from a
    # point on a quarter-metre grid, radii summing to 5, exact in float32
    pos[::4, 0] = np.round(pos[::4, 0] * 4) / 4 - np.array([1.5, 2.0])
    pos[::4, 1] = pos[::4, 0] + np.array([3.0, 4.0])
    radius[::4, 0], radius[::4, 1] = 2.0, 3.0
    valid[::4, :2] = True
    valid[1] = False
    valid[1, A - 1] = True                              # no valid partner
    valid[2] = True                                     # env 2 may hold the NaN
    leaves = tp.jax_leaves(tp.jax_batched_init(jcfg, pos, np.zeros((E, A, 2)), radius,
                                               np.ones((E, A)), valid=valid))
    dt = jcfg.np_dtype
    if nan:
        leaves["pos"] = leaves["pos"].copy()
        leaves["pos"][2, 0, 1] = np.nan
    leaves["past_actions"] = rng.uniform(-1, 1, leaves["past_actions"].shape).astype(dt)
    leaves["is_at_goal"] = rng.rand(E, A) < 0.2
    leaves["was_at_goal_already"] = leaves["is_at_goal"] & (rng.rand(E, A) < 0.5)
    leaves["in_collision"] = rng.rand(E, A) < 0.15
    leaves["was_in_collision_already"] = leaves["in_collision"] & (rng.rand(E, A) < 0.5)
    return leaves


def _jax_rewards(jcfg, leaves, static=None):
    """(collision, nearest, reward, in_collision) of ``vmap(_compute_rewards)``
    and ``vmap(_pairwise_collisions)``."""
    smap = None if static is None else jnp.asarray(static)

    def one(s):
        coll, near = jstep._pairwise_collisions(s, jcfg)
        new, r = jstep._compute_rewards(s, jcfg, smap)
        return coll, near, r, new.in_collision

    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(tp.jax_state(leaves))]


def _port_args(leaves, tcfg, static=None):
    t = {k: torch.from_numpy(np.array(leaves[k])) for k in (
        "pos", "radius", "valid", "is_at_goal", "was_at_goal_already",
        "was_in_collision_already", "in_collision", "past_actions")}
    wall = None
    if static is not None:
        wall = tgrid.wall_collisions(torch.from_numpy(static), t["pos"], t["radius"],
                                     t["valid"], tcfg)
    return (t["pos"], t["radius"], t["valid"], t["is_at_goal"], t["was_at_goal_already"],
            t["was_in_collision_already"], t["in_collision"], t["past_actions"], wall, tcfg)


def _assert_margins(near, cfg, tol):
    """Every finite nearest gap lies more than 10 ``tol`` from
    ``getting_close_range`` and from 0, unless it is exactly 0."""
    d = near[np.isfinite(near)]
    assert (np.abs(d - cfg.getting_close_range) > 10 * tol).all()
    assert ((d == 0) | (np.abs(d) > 10 * tol)).all()


def _compare(got, ref, dtype):
    coll, near, r, latched = (x.numpy() for x in got)
    ref_coll, ref_near, ref_r, ref_latched = ref
    tol = TOL[dtype]
    np.testing.assert_array_equal(coll, ref_coll)
    np.testing.assert_array_equal(latched, ref_latched)
    assert near.dtype == ref_near.dtype == r.dtype == ref_r.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(np.isnan(near), np.isnan(ref_near))
    np.testing.assert_array_equal(np.isinf(near), np.isinf(ref_near))
    np.testing.assert_allclose(near, ref_near, rtol=0, atol=tol)
    assert not np.isnan(r).any()
    np.testing.assert_allclose(r, ref_r, rtol=0, atol=tol)


def _run(dtype, A, cfg_name, E, nan=False, on_map=False):
    kw = dict(dtype=dtype, **CONFIGS[cfg_name], **(MAP if on_map else {}))
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    static = None
    if on_map:
        static = tgrid.load_static_map(tcfg, tgrid.world_map_path("002"))
    leaves = _leaves(jcfg, 10 + A, E, A, nan=nan, on_map=on_map)
    ref = _jax_rewards(jcfg, leaves, static)
    args = _port_args(leaves, tcfg, static)
    got = tpair.pairwise_rewards_plain(*args)
    _assert_margins(ref[1], tcfg, TOL[dtype])
    _compare(got, ref, dtype)
    return leaves, args, got, tcfg


def _x64(dtype):
    return jax.enable_x64(dtype == "float64")


def _branches(leaves, args, got, cfg):
    """Boolean ``[E, A]`` masks of the chain's branches, from the inputs and
    the port's flags."""
    coll, near, r, latched = (x.numpy() for x in got)
    wall = np.zeros_like(coll) if args[8] is None else args[8].numpy()
    goal, was_goal = leaves["is_at_goal"], leaves["was_at_goal_already"]
    eligible = ~goal & ~leaves["was_in_collision_already"]
    no_hit = eligible & ~coll & ~wall
    return {
        "goal_now": goal & ~was_goal & leaves["valid"],
        "already_at_goal": goal & was_goal & leaves["valid"],
        "hit_agent": eligible & coll,
        "hit_wall": eligible & ~coll & wall,
        "close": no_hit & (near <= cfg.getting_close_range) & leaves["valid"],
        "wiggly": no_hit & (np.abs(leaves["past_actions"][..., 0, 1])
                            > cfg.wiggly_behavior_threshold) & leaves["valid"],
        "no_hit": no_hit & leaves["valid"],
        "invalid": ~leaves["valid"],
    }


@pytest.mark.parametrize("cfg_name", ["clip_high", "clip_low", "default"])
@pytest.mark.parametrize("A", [2, 4, 20])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matches_jax_compute_rewards(dtype, A, cfg_name):
    with _x64(dtype):
        leaves, args, got, cfg = _run(dtype, A, cfg_name, E=128 if A < 20 else 16)
    b = _branches(leaves, args, got, cfg)
    r, latched = got[2].numpy(), got[3].numpy()
    for name in ("goal_now", "hit_agent", "close", "no_hit", "invalid"):
        assert b[name].any(), name
    assert (r[b["goal_now"]] == np.float64(cfg.reward_at_goal)).all()
    assert (r[b["invalid"]] == 0).all()
    assert (latched[b["hit_agent"]]).all()
    # the touching pairs collide with a gap of exactly 0
    touch = leaves["valid"][::4, 0] & leaves["valid"][::4, 1]
    assert touch.all() and got[0].numpy()[::4, :2].all()
    if A == 2:
        assert (got[1].numpy()[::4] == 0).all()
    lo, hi = tpair._clip_range(cfg)
    if cfg_name != "default":
        assert b["wiggly"].any()
        bound = hi if cfg_name == "clip_high" else lo
        assert (r[b["wiggly"]] == np.asarray(bound, dtype)).any(), "clip end not reached"
    if A == 4:
        assert b["already_at_goal"].any()
        assert np.isinf(got[1].numpy()[1]).all()         # no valid partner


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matches_jax_static_map_route(dtype):
    with _x64(dtype):
        leaves, args, got, cfg = _run(dtype, 4, "wall", E=64, on_map=True)
    b = _branches(leaves, args, got, cfg)
    wall = args[8].numpy()
    assert b["hit_wall"].any()
    r = got[2].numpy()
    assert (r[b["hit_wall"]] == np.asarray(cfg.reward_collision_with_wall, dtype)).all()
    both = b["hit_agent"] & wall                 # an agent collision takes precedence
    assert both.any()
    assert (r[both] == np.asarray(cfg.reward_collision_with_agent, dtype)).all()
    assert (got[3].numpy()[b["hit_wall"]]).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matches_jax_with_a_nan_position(dtype):
    with _x64(dtype):
        leaves, args, got, cfg = _run(dtype, 4, "clip_low", E=16, nan=True)
    near = got[1].numpy()
    assert np.isnan(near[2][leaves["valid"][2]]).any()
    assert not np.isnan(near[np.arange(16) != 2]).any()


def test_wrapper_routes_cpu_to_plain_without_counting():
    with _x64("float32"):
        jcfg = JCfg(dtype="float32", **CONFIGS["clip_low"])
        leaves = _leaves(jcfg, 4, 8, 4)
    args = _port_args(leaves, TCfg(dtype="float32", **CONFIGS["clip_low"]))
    before = ops.launch_counts()["pairwise"]
    got = tpair.pairwise_rewards(*args)
    want = tpair.pairwise_rewards_plain(*args)
    assert ops.launch_counts()["pairwise"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the latch is a new tensor: the state's flags stay as they were
    assert got[3] is not args[6] and torch.equal(args[6], torch.from_numpy(leaves["in_collision"]))


def test_lanes_for_gives_a_row_about_a_quarter_of_its_partners():
    """The kernel's layout: about A / 4 threads a row, a power of two from 1
    to 32; a layout the kernel does not take is refused."""
    got = {A: tpair.lanes_for(A) for A in (1, 2, 4, 7, 8, 20, 40, 127, 128, 1000)}
    assert got == {1: 1, 2: 1, 4: 1, 7: 1, 8: 2, 20: 4, 40: 8, 127: 16, 128: 32, 1000: 32}
    assert tpair._lanes(0, 20) == 4 and tpair._lanes(16, 20) == 16
    with pytest.raises(ValueError):
        tpair._lanes(3, 20)
