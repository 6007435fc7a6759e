"""The port's strict-parity route (``cfg.strict_parity=True``) against the
JAX package's on the CPU, bitwise.

Both compute ``atan2``, the unicycle step and the ego-frame refresh in host
numpy with the reference's scalar arithmetic (the port copies the JAX
package's ``_np_*`` functions), so float64 rollouts of NonCoop agents, with
plain unicycle dynamics and with the 3 rad/s turn-rate clip, must give the
same bits: ``pos``, ``heading``, ``vel``, ``speed``, ``dist_to_goal`` and
``heading_ego_frame`` at every step, from ``init_state`` on.  The JAX
route's host callbacks do not take a vmapped ``dt``, so JAX steps env by env
(as ``tests/test_torch_step.py`` does).

JAX's float32 strict route is no reference: with x64 on it refuses its own
ego-frame callback (float64 returned where float32 is declared), and with it
off its callbacks receive ``jax.Array`` operands (jax 0.9), so ``goal - pos``
and the other array-array operators in its ``_np_*`` functions run as JAX
float32 ops, not as the reference's numpy arithmetic.  The port's float32
route runs the functions on numpy arrays as written and casts the results to
float32; ``chip_smoke.py``'s ``strict_parity`` phase holds it card against
CPU.
"""

import jax
import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import env_step as t_env_step
from gym_collision_avoidance_torch.core import dynamics as tdyn
from gym_collision_avoidance_torch.core import maths as tmaths
from gym_collision_avoidance_torch.core import state as tstate
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu import env_step as j_env_step
from gym_collision_avoidance_tpu.core import state as jstate
from gym_collision_avoidance_tpu.scenarios import random_cases

NONCOOP = 2
LEAVES = ("pos", "heading", "vel", "speed", "dist_to_goal", "heading_ego_frame")
E, A, STEPS = 3, 4, 30


def _cases(seed):
    pool = random_cases.scenario_pool(E, A, seed=seed, side_length=4.0)
    return pool[..., 0:2], pool[..., 2:4], pool[..., 5], pool[..., 4]


@pytest.mark.parametrize("dtype,dynamics", [
    ("float64", (0, 0, 0, 0)),
    ("float64", (1, 1, 0, 1)),
    ("float64", (1, 1, 1, 1)),
])
def test_strict_rollout_matches_jax_bitwise(dtype, dynamics):
    kw = dict(dtype=dtype, strict_parity=True)
    jcfg, tcfg = JCfg.evaluate(**kw), TCfg.evaluate(**kw)
    pos, goal, radius, pref = _cases(seed=len(dynamics) + sum(dynamics))
    pid = np.full((E, A), NONCOOP, np.int32)
    dyn = np.tile(np.asarray(dynamics, np.int32), (E, 1))
    jstates = [jstate.init_state(jcfg, pos[e], goal[e], radius[e], pref[e], None, pid[e], dyn[e],
                                 rng=jax.numpy.zeros((2,), jax.numpy.uint32))
               for e in range(E)]
    state = tstate.init_state(tcfg, pos, goal, radius, pref, None, pid, dyn, device="cpu")
    jstep = jax.jit(lambda s: j_env_step(s, None, jcfg, None, (NONCOOP,))[0])
    turned = False
    for t in range(STEPS + 1):
        want = {k: np.stack([np.asarray(getattr(s, k)) for s in jstates]) for k in LEAVES}
        for k in LEAVES:
            np.testing.assert_array_equal(getattr(state, k).numpy(), want[k],
                                          err_msg=f"step {t}: {k}")
        turned |= bool((np.abs(np.diff(want["heading"])) > 0).any())
        if t < STEPS:
            jstates = [jstep(s) for s in jstates]
            state = t_env_step(state, None, tcfg, None, (NONCOOP,))[0]
    assert bool(state.is_done.any()) and not bool(state.is_at_goal.all())
    assert turned


def test_strict_route_pieces():
    """``arctan2(exact=True)`` is numpy's ``atan2`` in the inputs' dtype on
    their device, and the strict unicycle step clips the turn rate in
    float32 as the reference does."""
    rng = np.random.RandomState(5)
    y, x = rng.uniform(-2, 2, 1000), rng.uniform(-2, 2, 1000)
    for dtype in (torch.float32, torch.float64):
        got = tmaths.arctan2(torch.tensor(y, dtype=dtype), torch.tensor(x, dtype=dtype),
                             exact=True)
        want = np.arctan2(y.astype(got.numpy().dtype), x.astype(got.numpy().dtype))
        assert got.dtype == dtype and np.array_equal(got.numpy(), want)
    pos = torch.zeros((1, 2, 2), dtype=torch.float64)
    heading = torch.zeros((1, 2), dtype=torch.float64)
    action = torch.tensor([[[1.0, 1.2], [1.0, 0.1]]], dtype=torch.float64)
    _, _, _, new_heading, _ = tdyn.unicycle_step(pos, heading, action, 0.1,
                                                 max_turn_rate=tdyn.MAX_TURN_RATE, exact=True)
    assert new_heading[0, 0].item() == float(np.float32(np.float32(3.0) * np.float32(0.1)))
    assert new_heading[0, 1].item() == float(np.float32(0.1))
    torch.testing.assert_close(new_heading, tdyn.unicycle_step(
        pos, heading, action, 0.1, max_turn_rate=tdyn.MAX_TURN_RATE)[3])
