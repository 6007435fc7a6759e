"""Shared helpers of the ``test_torch_*`` parity tests: move batched JAX
states to the port as numpy arrays and compare the two packages' outputs.

Discrete leaves (bool, int) must be equal; float leaves agree to the
tolerance each test states (XLA's and torch's atan2/sin/cos differ by ulps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gym_collision_avoidance_torch import convert
from gym_collision_avoidance_tpu.core import state as jstate

# jax.config enables x64 in tests/conftest.py; CPU torch runs the port.
DEVICE = "cpu"

# The Tier-1 run spreads the tests over six xdist workers on one machine,
# and every worker imports this module when it collects the suite.  Torch's
# default of one intra-op thread per core in each worker oversubscribed the
# cores (the band-model files took minutes of worker time for seconds of
# work), so each worker keeps to one thread.
torch.set_num_threads(1)


def jax_leaves(state):
    """``{field: numpy array}`` of a (batched) JAX EnvState."""
    return {f.name: np.asarray(jax.device_get(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def jax_state(leaves):
    """A JAX EnvState from ``{field: numpy array}``."""
    return jstate.EnvState(**{k: jnp.asarray(v) for k, v in leaves.items()})


def to_torch(state):
    """The port's EnvState holding the leaves of a batched JAX EnvState."""
    return convert.state_from_numpy(jax_leaves(state), device=DEVICE)


def assert_tree_close(port, ref, rtol, atol, path="", angles=()):
    """Compare nested dicts / arrays: exact for bool and int, else
    ``assert_allclose`` with NaNs equal.  Leaves whose path ends with a name
    in ``angles`` are compared modulo 2 pi (an angle an ulp from pi wraps
    to either end of [-pi, pi))."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            assert_tree_close(port[k], ref[k], rtol, atol, f"{path}/{k}", angles)
        return
    port = np.asarray(port.detach().cpu().numpy() if hasattr(port, "detach") else port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (path, port.shape, ref.shape)
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        if path.endswith("/rng"):
            ref = ref.astype(np.int64)
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert port.dtype == ref.dtype, (path, port.dtype, ref.dtype)
        if any(path.endswith("/" + name) for name in angles):
            port = ref + (np.remainder(port - ref + np.pi, 2 * np.pi) - np.pi)
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=path)


def assert_states_close(port_state, ref_state, rtol, atol, angles=()):
    assert_tree_close(convert.state_to_numpy(port_state), jax_leaves(ref_state),
                      rtol, atol, "state", angles)


def jax_batched_init(cfg, pos, goal, radius, pref_speed, heading=None,
                     policy_id=None, dynamics_id=None, valid=None):
    """``vmap`` of the JAX ``init_state`` over ``[E, A, ...]`` numpy inputs."""
    E, A = pos.shape[:2]
    heading = np.full((E, A), np.nan) if heading is None else heading
    policy_id = np.full((E, A), 2, np.int32) if policy_id is None else policy_id
    dynamics_id = np.zeros((E, A), np.int32) if dynamics_id is None else dynamics_id
    valid = np.ones((E, A), bool) if valid is None else valid

    def one(p, g, r, s, h, pi, di, v):
        return jstate.init_state(cfg, p, g, r, s, h, pi, di, v,
                                 rng=jnp.zeros((2,), jnp.uint32))

    return jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (
        pos, goal, radius, pref_speed, heading, policy_id, dynamics_id, valid)))
