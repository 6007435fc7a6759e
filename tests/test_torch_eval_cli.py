"""The port's evaluation CLIs against the JAX package's on the CPU.

* ``scripts/eval_drl_long_torch.py:evaluate_drl_long`` against
  ``scripts/make_suite_reference.py:jax_eval_drl_long``, the JAX script's
  computation statement for statement (x64 off, as the script runs): the
  shipped DRL-Long net against RVO on the first 4 cases of the 2-agent suite
  for 30 steps.  Each case's at-goal, collision and timeout flags equal; the
  final positions within atol 1e-5 (reading: 2.4e-7; XLA's and torch's
  atan2/sin/cos differ by ulps).
* ``scripts/eval_trained_net_torch.py`` on the shipped flagship
  ``ppo_selfplay_10agent_tpu`` over the first 4 cases of the 2-agent cell
  against the JAX package's ``register_trained_policy`` and
  ``run_full_test_suite`` (float32, x64 off): every outcome and step count
  equal, the CLI's ``--reference`` gate passing on that record, and its
  summary CSV and outcome record written.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest

import _torch_parity as tp
from gym_collision_avoidance_tpu.config import EnvConfig as JCfg
from gym_collision_avoidance_tpu.harness import experiments as jexp
from gym_collision_avoidance_tpu.harness import registry as jreg
from scripts import eval_drl_long_torch, eval_trained_net_torch
from scripts import make_suite_reference as ref

POS_ATOL = 1e-5
FLAGSHIP = ref.FLAGSHIP
CASES = 4


@pytest.fixture(scope="module")
def drl_long_runs():
    with jax.enable_x64(False):
        want = ref.jax_eval_drl_long(ref.DRL_LONG, cases=CASES, steps=30)
    got = eval_drl_long_torch.evaluate_drl_long(ref.DRL_LONG, cases=CASES, steps=30,
                                                device=tp.DEVICE)
    return got, want


@pytest.mark.parametrize("flag", ["at_goal", "collision", "timeout"])
def test_eval_drl_long_outcomes_match_jax(drl_long_runs, flag):
    got, want = drl_long_runs
    assert got[flag].dtype == bool and got[flag].shape == (CASES,)
    np.testing.assert_array_equal(got[flag], want[flag])


def test_eval_drl_long_positions_match_jax(drl_long_runs):
    got, want = drl_long_runs
    assert got["at_goal"].any() and got["collision"].any()
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=POS_ATOL)


def test_eval_drl_long_cli_prints_the_jax_lines(capsys):
    assert eval_drl_long_torch.main([ref.DRL_LONG, "--cases", "2", "--steps", "3",
                                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("drl_long_2agent_rvo_tpu.npz on the frozen 2-agent 2-case suite "
                        "(learner=greedy DRL-Long net, others=RVO):")
    assert lines[1].startswith("  success ") and "timeout/stuck" in lines[1]


def test_eval_trained_net_matches_jax(tmp_path):
    name = os.path.splitext(os.path.basename(FLAGSHIP))[0]
    with jax.enable_x64(False):
        jreg.register_trained_policy(name, FLAGSHIP)
        df = jexp.run_full_test_suite(policies_to_test=(name,), num_agents_to_test=(2,),
                                      num_test_cases=CASES,
                                      cfg=JCfg.evaluate(dtype="float32"))[(2, name)]
    record = {"num_agents": 2, "policy": name, "cases": CASES,
              "outcome": [str(o) for o in df["outcome"]], "steps": [int(s) for s in df["steps"]]}
    reference = tmp_path / "reference.json"
    reference.write_text(json.dumps({"cells": [record]}))
    out = tmp_path / "out"
    assert eval_trained_net_torch.main([FLAGSHIP, "--agents", "2", "--cases", str(CASES),
                                        "--device", "cpu", "--out", str(out),
                                        "--reference", str(reference)]) == 0
    cells = json.loads((out / f"{name}_outcomes.json").read_text())["cells"]
    assert len(cells) == 1
    assert cells[0]["outcome"] == record["outcome"]
    assert cells[0]["steps"] == record["steps"]
    with open(out / f"{name}_summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert [(r["num_agents"], r["policy"]) for r in rows] == [("2", name)]
    assert float(rows[0]["pct_success"]) == cells[0]["summary"]["pct_success"]
