"""The port's ORCA and RVO policy against the JAX package on the CPU.

Tolerances: ``orca_velocities`` within 1e-12 (absolute plus relative) of the
JAX package in float64 for A in {1, 2, 4, 8, 10}, crowded worlds included
(LP3 runs there); in
float32 NaN-free and within 1e-4.  The RVO rollouts run in float64:
discrete outputs and counters exact, floats within atol 1e-9 (XLA's and
torch's atan2 differ by ulps).  The anti-collaborative draws are exact:
host draws draw for draw under a seeded ``RandomState``, and the stateless
route's threefry bits equal ``jax.random``'s: 64-bit draws for a float64
state, as the JAX step draws with x64 on (these tests' mode), and 32-bit
draws for a float32 state, as it draws with x64 off, where the float32 RVO
kernels agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import env_step as t_env_step
from gym_collision_avoidance_torch.core import prng
from gym_collision_avoidance_torch.core.state import init_state as t_init_state
from gym_collision_avoidance_torch.env import autoreset as tauto
from gym_collision_avoidance_torch.ops import orca as torca
from gym_collision_avoidance_torch.policies import rvo as trvo
from gym_collision_avoidance_torch.scenarios import random_cases as trc
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu import env_step as j_env_step
from gym_collision_avoidance_tpu.core.state import init_state as j_init_state
from gym_collision_avoidance_tpu.env import autoreset as jauto
from gym_collision_avoidance_tpu.ops import orca as jorca
from gym_collision_avoidance_tpu.policies import rvo as jrvo

RVO = 8
TOL = dict(rtol=0, atol=1e-9)
DT, ND, TH = 0.2, 1e6, 5.0


def _worlds(rng, E, A, crowded):
    """``E`` seeded worlds of ``A`` agents (the JAX ORCA test's sampler),
    some agents invalid."""
    span = 2.0 if crowded else 8.0
    pos = rng.uniform(-span, span, (E, A, 2))
    vel = rng.uniform(-1.0, 1.0, (E, A, 2))
    goal = rng.uniform(-span, span, (E, A, 2))
    radius = rng.uniform(0.2, 0.6, (E, A))
    max_speed = rng.uniform(0.5, 1.5, (E, A))
    d = goal - pos
    pref_vel = max_speed[..., None] * d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True),
                                                     1e-12)
    collab = rng.choice([0.0, 0.5, -0.5], (E, A), p=[0.2, 0.7, 0.1])
    valid = rng.rand(E, A) > 0.1
    return pos, vel, pref_vel, radius, max_speed, collab, valid


def _jax_orca(args, max_neighbors=None):
    return np.stack([np.asarray(jorca.orca_velocities(
        *(jnp.asarray(a[e]) for a in args), DT, ND, TH, max_neighbors=max_neighbors))
        for e in range(args[0].shape[0])])


@pytest.mark.parametrize("A,crowded", [(1, False), (2, False), (4, False), (4, True),
                                       (8, True), (10, True)])
def test_orca_float64_matches_jax(A, crowded):
    args = _worlds(np.random.RandomState(17 + A + int(crowded)), 12, A, crowded)
    ref = _jax_orca(args)
    targs = [torch.as_tensor(a) for a in args]
    got, fail = torca.orca_solve(*targs, DT, ND, TH)
    # XLA's fused ORCA is not bitwise its own op-by-op run in crowded LP3
    # worlds (the port is the op-by-op order); relative to the speeds, 1e-12
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    if crowded:
        assert (fail < A - 1).any(), "no agent reached LP3"


def test_orca_max_neighbors_matches_jax():
    args = _worlds(np.random.RandomState(3), 8, 4, True)
    got = torca.orca_velocities(*(torch.as_tensor(a) for a in args), DT, 3.0, TH,
                                max_neighbors=2)
    ref = np.stack([np.asarray(jorca.orca_velocities(
        *(jnp.asarray(a[e]) for a in args), DT, 3.0, TH, max_neighbors=2))
        for e in range(8)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("A", [2, 4, 10])
def test_orca_float32_is_finite_and_matches_jax(A):
    """float32, the serving dtype, where the 1e-300 guards are 0: on the
    JAX package's float32 test worlds and on crowded ones (LP3 runs in
    both at A = 10) every velocity is finite and within 1e-4."""
    rng = np.random.RandomState(29 + A)
    E = 6
    plain = (rng.uniform(-4, 4, (E, A, 2)), rng.uniform(-1, 1, (E, A, 2)),
             rng.uniform(-1, 1, (E, A, 2)), rng.uniform(0.2, 0.5, (E, A)), np.ones((E, A)),
             np.full((E, A), 0.5), np.ones((E, A), bool))
    crowded = _worlds(np.random.RandomState(30 + A), 12, A, True)
    for args, kind in ((plain, "plain"), (crowded, "crowded")):
        args = tuple(a.astype(np.float32) if a.dtype == np.float64 else a for a in args)
        got, fail = torca.orca_solve(*(torch.as_tensor(a) for a in args), DT, ND, TH)
        assert got.dtype == torch.float32
        assert torch.isfinite(got).all(), kind
        np.testing.assert_allclose(got.numpy(), _jax_orca(args), rtol=0, atol=1e-4, err_msg=kind)
        if A == 10:
            assert (fail < A - 1).any(), f"no agent reached LP3 ({kind})"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sqrt_rn_is_correctly_rounded(dtype):
    """``maths.sqrt_rn``, the package's square root, equals numpy's IEEE
    root bitwise on the CPU, on contiguous and strided inputs, zeros and
    subnormals included, and so do ``norm2`` and ``l2norm``."""
    from gym_collision_avoidance_torch.core import maths

    rng = np.random.RandomState(9)
    x = np.concatenate([rng.uniform(0, 64, 200_000), np.exp(rng.uniform(-80, 80, 50_000)),
                        [0.0, np.finfo(dtype).tiny / 4, np.inf]]).astype(dtype)
    for arr in (x, x[::3]):
        got = maths.sqrt_rn(torch.as_tensor(arr)).numpy()
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.view(np.uint8), np.sqrt(arr).view(np.uint8))
    vec = torch.as_tensor(rng.uniform(-3, 3, (64, 2)).astype(dtype))
    want = np.sqrt(vec[:, 0].numpy() ** 2 + vec[:, 1].numpy() ** 2)
    np.testing.assert_array_equal(maths.norm2(vec).numpy(), want)
    np.testing.assert_array_equal(maths.l2norm(vec[:, 0], vec[:, 1]).numpy(), want)


def test_orca_collab_coeff_zero_is_egoistic():
    """Head-on pair: the coefficient-0 agent keeps (nearly) its preferred
    velocity while a 0.5 agent deviates."""
    pos = torch.tensor([[-2.0, 0.0], [2.0, 0.0]], dtype=torch.float64)
    vel = torch.tensor([[1.0, 0.0], [-1.0, 0.0]], dtype=torch.float64)
    radius = torch.full((2,), 0.4, dtype=torch.float64)
    ones = torch.ones(2, dtype=torch.float64)
    valid = torch.ones(2, dtype=torch.bool)
    half = torca.orca_velocities(pos, vel, vel, radius, ones, 0.5 * ones, valid, DT, ND, TH)
    ego = torca.orca_velocities(pos, vel, vel, radius, ones,
                                torch.tensor([0.0, 0.5], dtype=torch.float64), valid,
                                DT, ND, TH)
    assert torch.linalg.norm(ego[0] - vel[0]) < torch.linalg.norm(half[0] - vel[0])
    ref = jorca.orca_velocities(jnp.asarray(pos.numpy()), jnp.asarray(vel.numpy()),
                                jnp.asarray(vel.numpy()), jnp.asarray(radius.numpy()),
                                jnp.ones(2), jnp.asarray([0.0, 0.5]), jnp.ones(2, bool),
                                DT, ND, TH)
    np.testing.assert_allclose(ego.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_rvo_stop_and_turn():
    """An RVO agent whose goal is behind it stops and turns at pi/6."""
    kw = dict(pos=np.array([[[0.0, 0.0], [50.0, 50.0]]]),
              goal=np.array([[[-5.0, 0.0], [55.0, 50.0]]]),
              radius=np.full((1, 2), 0.3), pref_speed=np.ones((1, 2)),
              heading=np.zeros((1, 2)))
    st = t_init_state(TCfg(dtype="float64"), **kw, device="cpu")
    action = trvo.rvo_kernel(st, TCfg(dtype="float64"), None)
    assert action[0, 0, 0] == 0.0
    assert abs(abs(action[0, 0, 1].item()) - np.pi / 6) <= 1e-12
    jst = j_init_state(JCfg(dtype="float64"), **{k: v[0] for k, v in kw.items()})
    np.testing.assert_allclose(action[0].numpy(),
                               np.asarray(jrvo.rvo_kernel(jst, JCfg(dtype="float64"), None)),
                               rtol=0, atol=1e-12)


def test_anti_collab_host_draws_draw_for_draw():
    cfg_kw = dict(dt=0.1, rvo_collab_coeff=-0.7, rvo_anti_collab_t=1.0)
    jcfg, tcfg = JCfg(**cfg_kw), TCfg(**cfg_kw)
    rng = np.random.RandomState(0)
    jrng, trng = np.random.RandomState(91), np.random.RandomState(91)
    jflags = tflags = np.ones(6, bool)
    for step in range(60):
        t = np.round(step * 0.1 + rng.choice([0.0, 0.05], 6), 6)
        active = rng.rand(6) > 0.2
        jflags = jrvo.anti_collab_host_draws(jflags, t, active, jcfg, jrng)
        tflags = trvo.anti_collab_host_draws(tflags, t, active, tcfg, trng)
        np.testing.assert_array_equal(tflags, jflags)
    assert jrng.randint(1 << 30) == trng.randint(1 << 30)
    assert not tflags.all() and tflags.any()


def test_threefry_bits_match_jax():
    """``fold_in`` and ``bernoulli`` bit for bit against ``jax.random``, in
    32 and 64 bits."""
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 2 ** 32, (64, 2), dtype=np.uint64).astype(np.uint32)
    data = rng.randint(-3, 2 ** 31 - 1, 64)
    jkeys = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data))
    tkeys = prng.fold_in(torch.as_tensor(keys.astype(np.int64)), torch.as_tensor(data))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys).astype(np.int64))
    for p in (0.3, 0.5, 0.8):
        for np_dtype, dtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
            want = jax.vmap(lambda k: jax.random.bernoulli(k, np_dtype(p)))(jkeys)
            np.testing.assert_array_equal(prng.bernoulli(tkeys, p, dtype).numpy(),
                                          np.asarray(want))


@pytest.mark.parametrize("x64", [False, True])
def test_anti_collab_draw_width_follows_the_state_dtype(x64):
    """``rvo_kernel`` passes ``bernoulli`` a Python float, so JAX draws 32
    bits with x64 off and 64 with it on, whatever the state's dtype.  The
    port draws by the state's dtype: a float32 state stands for x64 off and
    a float64 state for x64 on, and then the draws are equal.  A float32
    state stepped by JAX with x64 on draws other bits than the port."""
    p = 1.0 - 0.6
    keys = np.random.RandomState(12).randint(0, 2 ** 32, (256, 2), dtype=np.uint64)
    tkeys = torch.as_tensor(keys.astype(np.int64))
    with jax.enable_x64(x64):
        want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p))(
            jnp.asarray(keys.astype(np.uint32))))
    port_dtype, other = (torch.float64, torch.float32) if x64 else (torch.float32, torch.float64)
    np.testing.assert_array_equal(prng.bernoulli(tkeys, p, port_dtype).numpy(), want)
    assert (prng.bernoulli(tkeys, p, other).numpy() != want).any()
    if not x64:   # the whole float32 route under JAX's default mode
        with jax.enable_x64(False):
            jcfg, tcfg = _rvo_cfgs(dtype="float32", rvo_collab_coeff=-0.6, rvo_anti_collab_t=0.7)
            jst, tst = _rvo_states(jcfg)
            jact = jax.vmap(lambda s: jrvo.rvo_kernel(s, jcfg, None))(jst)
        coeff = trvo._collab_coeff(tst, tcfg, None)
        assert len(set(coeff.flatten().tolist())) == 2
        np.testing.assert_allclose(trvo.rvo_kernel(tst, tcfg, None).numpy(), np.asarray(jact),
                                   rtol=0, atol=1e-5)


def _rvo_cfgs(**kw):
    kw = {"dtype": "float64", "done_mode": "evaluate", **kw}
    return JCfg(**kw), TCfg(**kw)


def _rvo_states(jcfg, E=8, A=4, seed=0):
    pool = trc.scenario_pool(E, A, seed=seed, side_length=4.0)
    pid = np.full(A, RVO, np.int32)
    keys = np.random.RandomState(seed).randint(0, 2 ** 32, (E, 2), dtype=np.uint64)
    jst = jax.vmap(lambda c, k: jauto.state_from_case(jcfg, c, pid, rng=k))(
        jnp.asarray(pool), jnp.asarray(keys.astype(np.uint32)))
    return jst, tp.to_torch(jst)


@pytest.mark.parametrize("coeff", [0.5, 0.0, -0.6])
def test_rvo_rollout_matches_jax(coeff):
    """E = 8 envs of 4 RVO agents for 40 steps in float64; -0.6 takes the
    stateless anti-collaborative route (threefry draws per agent and 0.7 s
    window from each env's key)."""
    jcfg, tcfg = _rvo_cfgs(rvo_collab_coeff=coeff, rvo_anti_collab_t=0.7)
    jst, tst = _rvo_states(jcfg)
    start = tst.dist_to_goal
    jstep = jax.jit(jax.vmap(lambda s: j_env_step(s, None, jcfg, None, (RVO,))))
    names = ("obs", "rewards", "game_over")
    for t in range(40):
        jst, jobs, jrew, jgo, _ = jstep(jst)
        tst, tobs, trew, tgo, _ = t_env_step(tst, None, tcfg, None, (RVO,))
        tp.assert_tree_close(dict(zip(names, (tobs, trew, tgo))),
                             dict(zip(names, (jobs, jrew, jgo))), path=f"step{t}", **TOL)
        tp.assert_states_close(tst, jst, **TOL)
    assert (tst.dist_to_goal < start - 1.0).any()
    if coeff < 0:   # the draws gave both coefficients
        assert len(set(trvo._collab_coeff(tst, tcfg, None).flatten().tolist())) == 2


def test_rvo_host_draws_route_matches_jax():
    """``params["rvo_use_noncoop"]`` flags from ``anti_collab_host_draws``,
    one env (the flags are per env), 30 steps."""
    jcfg, tcfg = _rvo_cfgs(rvo_collab_coeff=-0.8)
    jst, tst = _rvo_states(jcfg, E=1, seed=2)
    jstep = jax.jit(jax.vmap(lambda s, f: j_env_step(s, None, jcfg, {"rvo_use_noncoop": f},
                                                     (RVO,)), in_axes=(0, None)))
    host = np.random.RandomState(5)
    flags, seen = np.ones(4, bool), set()
    for t in range(30):
        flags = trvo.anti_collab_host_draws(flags, tst.t[0].numpy(), ~tst.is_done[0].numpy(),
                                            tcfg, host)
        seen.add(tuple(flags))
        jst = jstep(jst, jnp.asarray(flags))[0]
        tst = t_env_step(tst, None, tcfg, {"rvo_use_noncoop": flags}, (RVO,))[0]
        tp.assert_states_close(tst, jst, **TOL)
    assert len(seen) > 1


def test_orca4_serving_loop_matches_jax():
    """The ``orca4`` configuration at E = 8, float64, 100 steps across
    resets."""
    jcfg, tcfg = _rvo_cfgs()
    E, A, N = 8, 4, 8
    pool = trc.scenario_pool(N, A, seed=0, side_length=4.0)
    pid = np.full(A, RVO, np.int32)
    jstep = jax.jit(jax.vmap(jauto.make_autoreset_step(jcfg, jnp.asarray(pool), pid, (RVO,))))
    jst = jax.vmap(lambda c: jauto.state_from_case(jcfg, c, pid))(jnp.asarray(pool))
    jc = jnp.arange(E, dtype=jnp.int32)
    tstep = tauto.make_autoreset_step(tcfg, pool, pid, (RVO,), device=tp.DEVICE)
    tst = tauto.state_from_case(tcfg, pool, pid, device=tp.DEVICE)
    tc = torch.arange(E, dtype=torch.int32)
    names = ("counter", "obs", "rewards", "game_over")
    for t in range(100):
        jst, jc, jobs, jrew, jgo = jstep(jst, jc)
        tst, tc, tobs, trew, tgo = tstep(tst, tc)
        tp.assert_tree_close(dict(zip(names, (tc, tobs, trew, tgo))),
                             dict(zip(names, (jc, jobs, jrew, jgo))), path=f"step{t}", **TOL)
    tp.assert_states_close(tst, jst, **TOL)
    assert (np.asarray(jc) - np.arange(E)).min() >= 1


def test_orca4_float32_loop_stays_finite():
    cfg = TCfg(dtype="float32", done_mode="evaluate")
    pool = trc.scenario_pool(16, 4, seed=0, side_length=4.0)
    pid = np.full(4, RVO, np.int32)
    step = tauto.make_autoreset_step(cfg, pool, pid, (RVO,), device=tp.DEVICE)
    st = tauto.state_from_case(cfg, pool[np.arange(64) % 16], pid, device=tp.DEVICE)
    c = torch.arange(64, dtype=torch.int32)
    for _ in range(120):
        st, c = step(st, c)[:2]
    for name, leaf in st.items():
        if leaf.is_floating_point():
            assert torch.isfinite(leaf).all(), name
    assert int((c - torch.arange(64)).sum()) > 0
