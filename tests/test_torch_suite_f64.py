"""The port's ``harness.experiments.run_batched_episodes`` against the JAX
package's on the CPU: the first 8 cases of the 2- and 4-agent frozen suites
for RVO, GA3C-CADRL-10 and CADRL, in float64 (JAX with x64, as
``tests/conftest.py`` sets it; ``tests/test_torch_suite_f32.py`` runs
float32).
``steps``, ``outcome``, ``collision``, ``all_at_goal``, ``any_stuck`` and
``num_agents`` are held exactly, the float stats to ``FLOAT_TOL`` of their
dtype (XLA's and torch's atan2/sin/cos differ by ulps, which an episode
carries forward into the rewards' getting-close terms).  The helpers are
``tests/test_torch_harness.py``'s.
"""

import pytest

from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch.harness import experiments as tx
from test_torch_harness import CELL_POLICIES, CPU, FLOAT_TOL, _assert_stats_equal, _jax_cell


@pytest.mark.parametrize("num_agents", [2, 4])
def test_run_batched_episodes_matches_jax_64(num_agents):
    """The first 8 cases of the frozen suite, all three policies."""
    for policy in CELL_POLICIES:
        got = tx.run_suite_cell(num_agents, policy, 8, TCfg.evaluate(dtype="float64"), device=CPU)
        _assert_stats_equal(got.stats, _jax_cell(num_agents, policy, "float64", 8), FLOAT_TOL["float64"])
