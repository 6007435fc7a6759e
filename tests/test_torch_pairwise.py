"""K1 (pairwise collision / nearest gap) in the port: the plain PyTorch
version against the JAX package's XLA twin and its Pallas kernel run in
interpret mode, and a brute-force oracle.  The CUDA kernel against the
plain version is in ``test_torch_pairwise_cuda.py``, which imports no JAX
so that it runs on a machine with a card.

Tolerances: collision flags are exact.  Gaps are bitwise equal between
the CUDA kernel and the plain version (the same IEEE operations in the same
order, no FMA).  Against the JAX package on the CPU they agree to 1e-14 in
float64 and 1e-6 in float32, not bitwise: XLA's CPU backend contracts
``dx*dx + dy*dy`` into FMAs in some fusions, so its XLA twin and its
interpret-mode Pallas kernel already differ from each other by that much
(a 1-ulp change of ``dist`` is several ulps of ``dist - r_i - r_j``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gym_collision_avoidance_torch import ops
from gym_collision_avoidance_torch.ops import pairwise as tpair
from gym_collision_avoidance_tpu.env import step as jstep
from gym_collision_avoidance_tpu.ops import pairwise as jpair


def _inputs(seed, E, A, dtype, touching=False):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-3, 3, (E, A, 2)).astype(dtype)
    radius = rng.uniform(0.3, 1.2, (E, A)).astype(dtype)
    valid = rng.rand(E, A) > 0.2
    if touching:
        # exactly-touching pairs: a 3-4-5 triangle between agents 0 and 1
        # with radii summing to 5, so dist == r0 + r1 exactly
        pos[:, 1] = pos[:, 0] + np.array([3.0, 4.0], dtype)
        radius[:, 0], radius[:, 1] = 2.0, 3.0
    return pos, radius, valid


def _jax_twin(pos, radius, valid):
    """vmap of env/step.py:_pairwise_collisions over envs."""
    def one(p, r, v):
        st = type("S", (), {"pos": p, "radius": r, "valid": v})()
        return jstep._pairwise_collisions(st, None)

    return jax.jit(jax.vmap(one))(jnp.asarray(pos), jnp.asarray(radius),
                                  jnp.asarray(valid))


def _pallas_interpret(pos, radius, valid, EB=4):
    E, A, _ = pos.shape
    return pl.pallas_call(
        jpair._kernel,
        grid=(E // EB,),
        in_specs=[
            pl.BlockSpec((EB, A, 2), lambda i: (i, 0, 0)),
            pl.BlockSpec((EB, A), lambda i: (i, 0)),
            pl.BlockSpec((EB, A), lambda i: (i, 0)),
        ],
        out_specs=(
            pl.BlockSpec((EB, A), lambda i: (i, 0)),
            pl.BlockSpec((EB, A), lambda i: (i, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((E, A), jnp.bool_),
            jax.ShapeDtypeStruct((E, A), pos.dtype),
        ),
        interpret=True,
    )(jnp.asarray(pos), jnp.asarray(radius), jnp.asarray(valid))


def _bitwise_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(f"u{a.itemsize}"), b[ok].view(f"u{b.itemsize}"))


_GAP_ATOL = {np.float64: 1e-14, np.float32: 1e-6}


def _close_to_jax(near, ref_near, dtype):
    ref_near = np.asarray(ref_near)
    assert near.dtype == ref_near.dtype
    np.testing.assert_array_equal(np.isnan(near), np.isnan(ref_near))
    np.testing.assert_array_equal(np.isinf(near), np.isinf(ref_near))
    np.testing.assert_allclose(near, ref_near, rtol=0, atol=_GAP_ATOL[dtype])


def _plain(pos, radius, valid):
    coll, near = tpair.pairwise_collisions(
        torch.from_numpy(pos), torch.from_numpy(radius), torch.from_numpy(valid)
    )
    return coll.numpy(), near.numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("E,A", [(8, 4), (8, 16)])
def test_plain_matches_jax_twin_and_pallas_interpret(dtype, E, A):
    pos, radius, valid = _inputs(1, E, A, dtype, touching=True)
    coll, near = _plain(pos, radius, valid)
    assert coll.dtype == bool and near.dtype == dtype
    assert coll[valid[:, 0] & valid[:, 1], 0].all()       # touching counts
    for ref_coll, ref_near in (_jax_twin(pos, radius, valid),
                               _pallas_interpret(pos, radius, valid)):
        np.testing.assert_array_equal(coll, np.asarray(ref_coll))
        _close_to_jax(near, ref_near, dtype)


def test_plain_matches_brute_force_oracle():
    pos, radius, valid = _inputs(2, 6, 8, np.float64)
    valid[0] = False                 # an env with no valid agent
    valid[1] = False
    valid[1, 3] = True               # an env with one valid agent
    coll, near = _plain(pos, radius, valid)
    E, A = valid.shape
    for e in range(E):
        for i in range(A):
            gaps, hit = [], False
            for j in range(A):
                if i == j or not valid[e, i] or not valid[e, j]:
                    continue
                d = math.hypot(*(pos[e, i] - pos[e, j]))
                c = radius[e, i] + radius[e, j]
                gaps.append(d - c)
                hit |= d <= c
            assert coll[e, i] == hit
            expect = min(gaps) if gaps else math.inf
            np.testing.assert_allclose(near[e, i], expect, rtol=0, atol=1e-12)


def test_plain_propagates_nan_like_jax():
    pos, radius, valid = _inputs(3, 4, 4, np.float32)
    valid[:] = True
    pos[0, 2, 0] = np.nan
    coll, near = _plain(pos, radius, valid)
    ref_coll, ref_near = _jax_twin(pos, radius, valid)
    np.testing.assert_array_equal(coll, np.asarray(ref_coll))
    _close_to_jax(near, ref_near, np.float32)
    assert np.isnan(near[0]).all() and not np.isnan(near[1:]).any()


def test_wrapper_routes_cpu_to_plain_without_counting():
    pos, radius, valid = (torch.from_numpy(x) for x in _inputs(4, 4, 4, np.float32))
    before = ops.launch_counts()["pairwise"]
    got = tpair.pairwise_collisions(pos, radius, valid)
    want = tpair.pairwise_collisions_plain(pos, radius, valid)
    assert ops.launch_counts()["pairwise"] == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
