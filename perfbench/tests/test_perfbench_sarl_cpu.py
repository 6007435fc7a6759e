"""CPU tests of the benchmark's SARL cell, ``sarl6.serve``, at the tiny size
of ``test_perfbench_cpu.py``: a run comes out correct with every policy step
after the window compared, the program's bfloat16-rounded weights do not,
and the reference follows the program's own CPU step state for state.  Run
from the repository root:

    python -m pytest -q perfbench/tests/test_perfbench_sarl_cpu.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import check, reference, run, scenarios  # noqa: E402
from perfbench.reference import sim  # noqa: E402
from perfbench.tests.test_perfbench_cpu import TINY, tiny_run  # noqa: E402

CELL = "sarl6.serve"


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_run_is_correct_and_judged():
    line = tiny_run(CELL)
    assert line["correct"], line["check"]
    assert set(line["metrics"]) == {"env_steps_per_s", "dispatch_p95_ms", "setup_s"}
    assert line["check"]["diverged_share"]["value"] == 0.0
    assert line["check"]["float_err"]["value"] <= 1e-6
    steps = TINY["check"]["after_dispatches"] * run.load_cell(CELL)["traffic"][
        "steps_per_dispatch"]
    assert line["policy_steps_compared"] == {"steps": steps, "of": steps}


def test_lower_precision_fails():
    """The control: the program's net with bfloat16-rounded weights."""
    line = tiny_run(CELL, control="bf16_weights")
    assert not line["correct"]
    assert line["check"]["float_err"]["value"] > line["check"]["float_err"]["limit"]


def test_a_traced_run_reads_its_layers():
    line = tiny_run(CELL, trace=True)
    assert line["correct"]
    assert {"enqueue_ms_per_step.serve", "kernels_per_step.serve",
            "device_idle_pct.serve"} <= set(line["metrics"])
    # no product kernel runs on a device in a CPU trace: the roofline reads nothing
    assert "sarl_net_roofline" not in line["metrics"]


def test_the_reference_follows_the_programs_cpu_step():
    """Ten steps of the program's auto-reset step on the CPU, the reference
    following each from the program's state: equal states and counters."""
    from gym_collision_avoidance_torch.config import EnvConfig
    from gym_collision_avoidance_torch.env import autoreset
    from perfbench.kinds import serve

    config = run.load_cell(CELL)["config"]
    A = config["num_agents"]
    pool = scenarios.scenario_pool(8, A, seed=3)
    policy_id = np.full(A, config["policy_id"], np.int32)
    params = serve._program_params(config, "cpu")
    env = EnvConfig(**config["env"])
    step = autoreset.make_autoreset_step(env, pool, policy_id, (config["policy_id"],),
                                         params=params, device="cpu")
    state = autoreset.state_from_case(env, pool[np.arange(6) % 8], policy_id, device="cpu")
    counter = torch.arange(6, dtype=torch.int32)
    cfg = sim.Config.from_env(config["env"], config.get("world"))
    policy = reference.module(config["reference"]["policy"])
    weights = policy.load(str(ROOT / config["reference"]["weights"]), "cpu")
    fresh, fresh_obs = sim.fresh_pool(cfg, pool, policy_id, "cpu")
    for _ in range(10):
        s = {k: v.clone() for k, v in state.items()}
        act, _, _, _ = policy.decide(weights, s, cfg)
        s, obs, _, game_over = sim.env_step(s, act, cfg)
        s, obs, c = sim.reset_where_done(s, obs, counter, game_over, fresh, fresh_obs)
        state, counter = step(state, counter)[:2]
        diverged, err = check.compare_states(s, c, dict(state.items()), counter)
        assert not bool(diverged.any()) and float(err.max()) == 0.0
