"""The port's ``harness.experiments.run_batched_episodes`` against the JAX
package's on the CPU: the first 8 cases of the 2- and 4-agent frozen suites
for RVO, GA3C-CADRL-10 and CADRL, in float32 (JAX under
``jax.enable_x64(False)``, as ``scripts/run_full_test_suite.py`` runs;
``tests/test_torch_suite_f64.py`` runs float64).
``steps``, ``outcome``, ``collision``, ``all_at_goal``, ``any_stuck`` and
``num_agents`` are held exactly, the float stats to ``FLOAT_TOL`` of their
dtype and the one RVO deadlock to ``DEADLOCK_TOL`` (XLA's and torch's
atan2/sin/cos differ by ulps, which an episode carries forward into the
rewards' getting-close terms).  The helpers are
``tests/test_torch_harness.py``'s.
"""

import pytest

from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch.harness import experiments as tx
from test_torch_harness import (CELL_POLICIES, CPU, DEADLOCK_TOL, FLOAT_TOL,
                                _assert_stats_equal, _jax_cell)


@pytest.mark.parametrize("num_agents", [2, 4])
def test_run_batched_episodes_matches_jax_32(num_agents):
    """The first 8 cases of the frozen suite, all three policies."""
    for policy in CELL_POLICIES:
        got = tx.run_suite_cell(num_agents, policy, 8, TCfg.evaluate(dtype="float32"), device=CPU)
        wide = {case: tol for (n, p, case), tol in DEADLOCK_TOL.items()
                if (n, p) == (num_agents, policy)}
        _assert_stats_equal(got.stats, _jax_cell(num_agents, policy, "float32", 8),
                            FLOAT_TOL["float32"], wide)
