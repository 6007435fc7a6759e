"""The port's EnvConfig is a copy of the JAX package's: same fields, same
defaults, same preset constructors, same constants."""

import dataclasses

import numpy as np
import pytest

from gym_collision_avoidance_torch import config as tcfg
from gym_collision_avoidance_tpu import config as jcfg


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_fields_and_defaults_match():
    assert _fields(tcfg.EnvConfig) == _fields(jcfg.EnvConfig)


@pytest.mark.parametrize("preset", ["evaluate", "train"])
def test_presets_match(preset):
    t = getattr(tcfg.EnvConfig, preset)(dtype="float64", sensing_horizon=3.0)
    j = getattr(jcfg.EnvConfig, preset)(dtype="float64", sensing_horizon=3.0)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.np_dtype == j.np_dtype == np.float64
    assert dataclasses.asdict(t.replace(dt=0.5)) == dataclasses.asdict(j.replace(dt=0.5))


def test_constants_match():
    for name in ("SORT_CLOSEST_FIRST", "SORT_CLOSEST_LAST", "SORT_TIME_TO_IMPACT",
                 "DONE_MODE_EVALUATE", "DONE_MODE_SINGLE_AGENT", "DONE_MODE_LEARNING"):
        assert getattr(tcfg, name) == getattr(jcfg, name)
