"""The port's scenario pools are bitwise equal to the JAX package's: the
generator is the same numpy code consuming the same np.random stream."""

import numpy as np
import pytest

from gym_collision_avoidance_torch.scenarios import presets as tpresets
from gym_collision_avoidance_torch.scenarios import random_cases as trc
from gym_collision_avoidance_tpu.scenarios import presets as jpresets
from gym_collision_avoidance_tpu.scenarios import random_cases as jrc


def _bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,agents,seed,kw", [
    (64, 4, 0, dict(side_length=4.0)),
    (16, 6, 3, dict(side_length=6.0, speed_bnds=(0.3, 1.5))),
])
def test_scenario_pool_bitwise(n, agents, seed, kw):
    _bitwise(trc.scenario_pool(n, agents, seed=seed, **kw),
             jrc.scenario_pool(n, agents, seed=seed, **kw))


def test_scenario_pool_mixed_bitwise():
    _bitwise(trc.scenario_pool_mixed(24, (2, 3, 4), seed=5),
             jrc.scenario_pool_mixed(24, (2, 3, 4), seed=5))


def test_random_scenario_and_pad_match():
    t = trc.random_scenario(rng=np.random.RandomState(7), policies_arg="noncoop").pad_to(6)
    j = jrc.random_scenario(rng=np.random.RandomState(7), policies_arg="noncoop").pad_to(6)
    for field in ("pos", "goal", "pref_speed", "radius", "heading", "policy_id",
                  "dynamics_id", "valid"):
        _bitwise(np.asarray(getattr(t, field)), np.asarray(getattr(j, field)))
    assert t.active_policies == j.active_policies


def test_presets_match():
    for name, args in (("circle_scenario", (5,)), ("two_agents_swap", ())):
        t, j = getattr(tpresets, name)(*args), getattr(jpresets, name)(*args)
        for field in ("pos", "goal", "pref_speed", "radius", "policy_id", "dynamics_id"):
            _bitwise(np.asarray(getattr(t, field)), np.asarray(getattr(j, field)))
