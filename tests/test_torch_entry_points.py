"""The port's remaining entry points against the JAX package's, on the CPU.

* ``core/maths.py``'s ``find_nearest``, ``rad2deg``, ``l2normsq`` and
  ``yaw_to_quaternion`` on seeded float32 and float64 inputs: the first three
  bitwise (IEEE operations in one order), the quaternion within 2 ulps of
  its dtype (XLA's and torch's sin/cos differ by ulps).
* ``scripts/regenerate_suites_torch.py`` against ``scripts/regenerate_suites.py``
  at 20 cases: the same file names, and every pickle equal byte for byte.
* The dataset CLIs at tiny sizes against the JAX harness (float64, their
  default): ``run_trajectory_dataset_creator_torch.py --trajs 1`` against
  ``collect_trajectory_dataset(1)`` (step counts equal, every array within
  atol 1e-9) and ``collect_regression_dataset_torch.py`` at 12 train and 6
  test points of 2 agents against ``collect_regression_dataset`` (states and
  values within atol 1e-9, actions within atol 1e-9).
* ``run_cadrl_formations_torch.py --episodes 2`` against the JAX package's
  ``run_formations_campaign`` (float32, x64 off as its CLI runs): each
  letter's outcome and step count equal.
* ``example_torch.py`` runs the gym API on the CPU for its 100 steps and
  saves its plot.
* ``train_curriculum_torch.sh`` runs the JAX curriculum's six stages, with
  its flags, through ``train_ppo_torch.py``.
"""

import os
import pickle
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread per process)
from gym_collision_avoidance_torch.core import maths as tm
from gym_collision_avoidance_tpu.core import maths as jm
from gym_collision_avoidance_tpu.harness import datasets as jdatasets
from gym_collision_avoidance_tpu.harness import experiments as jexp
from scripts import (collect_regression_dataset_torch, example_torch, regenerate_suites,
                     regenerate_suites_torch, run_cadrl_formations_torch,
                     run_trajectory_dataset_creator_torch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET_ATOL = 1e-9
QUAT_ULPS = 2


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_maths_helpers_match_jax(dtype):
    rng = np.random.RandomState(7)
    array = np.sort(rng.uniform(-5, 5, 13)).astype(dtype)
    values = np.concatenate([rng.uniform(-6, 6, 9), array[[2, 5]],
                             (array[3:5] + array[4:6]) / 2]).astype(dtype)
    x, y = rng.randn(4, 3, 2).astype(dtype), rng.randn(4, 3, 2).astype(dtype)
    yaw = rng.uniform(-4, 4, 17).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want_near, want_idx = jm.find_nearest(jnp.asarray(array), jnp.asarray(values))
        want = {"rad2deg": jm.rad2deg(jnp.asarray(yaw)),
                "l2normsq": jm.l2normsq(jnp.asarray(x), jnp.asarray(y))}
        want_quat = jm.yaw_to_quaternion(jnp.asarray(yaw))
    got_near, got_idx = tm.find_nearest(torch.tensor(array), torch.tensor(values))
    np.testing.assert_array_equal(_np(got_idx), np.asarray(want_idx))
    np.testing.assert_array_equal(_np(got_near), np.asarray(want_near))
    # a scalar value and numpy inputs, as the JAX helper takes them
    near, idx = tm.find_nearest(array, float(values[0]))
    assert _np(idx).shape == (1,) and _np(near)[0] == array[_np(idx)[0]]
    got = {"rad2deg": tm.rad2deg(torch.tensor(yaw)),
           "l2normsq": tm.l2normsq(torch.tensor(x), torch.tensor(y))}
    for k in want:
        assert _np(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    got_quat = tm.yaw_to_quaternion(torch.tensor(yaw))
    ulp = np.finfo(dtype).eps
    for g, w in zip(got_quat, want_quat):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=QUAT_ULPS * ulp)
    np.testing.assert_array_equal(_np(got_quat[0]), 0)


def test_regenerate_suites_matches_jax_bitwise(tmp_path):
    regenerate_suites.main(str(tmp_path / "jax"), num_test_cases=20)
    regenerate_suites_torch.main(str(tmp_path / "port"), num_test_cases=20)
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert names == [f"vpref1.0_r0.1-0.1/{n}_agents_20_cases_seed000.p" for n in (2, 3, 4)]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_trajectory_dataset_cli_matches_jax(tmp_path):
    out = tmp_path / "trajs.p"
    assert run_trajectory_dataset_creator_torch.main(
        ["--trajs", "1", "--out", str(out), "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        got = pickle.load(f)
    want = jdatasets.collect_trajectory_dataset(num_trajs=1)
    assert [len(t) for t in got] == [len(t) for t in want] and len(got[0]) > 10
    for g, w in zip(got[0], want[0]):
        assert sorted(g) == sorted(w)
        for k in w:
            gv, wv = (g[k], w[k]) if k != "pedestrian_state" else (
                np.concatenate([g[k]["position"], g[k]["velocity"]]),
                np.concatenate([w[k]["position"], w[k]["velocity"]]))
            np.testing.assert_allclose(np.asarray(gv), np.asarray(wv), rtol=0,
                                       atol=DATASET_ATOL, err_msg=k)


def test_regression_dataset_cli_matches_jax(tmp_path):
    assert collect_regression_dataset_torch.main(
        ["--train", "12", "--test", "6", "--agents", "2", "--out", str(tmp_path),
         "--device", "cpu"]) == 0
    for mode, n, seed in (("train", 12, 0), ("test", 6, 1)):
        with open(tmp_path / f"2_agents_cadrl_dataset_action_value_{mode}.p", "rb") as f:
            got = pickle.load(f)
        want = jdatasets.collect_regression_dataset(n, num_agents=2, seed=seed)
        for g, w, what in zip(got, want, ("states", "actions", "values")):
            assert g.shape == np.asarray(w).shape == (n,) + g.shape[1:], what
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=DATASET_ATOL,
                                       err_msg=f"{mode} {what}")


def test_formations_cli_matches_jax(tmp_path, capsys):
    assert run_cadrl_formations_torch.main(["--episodes", "2", "--out", str(tmp_path),
                                            "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    with jax.enable_x64(False):
        want = jexp.run_formations_campaign(num_episodes=2)
    assert got == [f"{letter}: {stats['outcome']} in {stats['steps']} steps"
                   for letter, stats, _ in want]
    assert sorted(os.listdir(tmp_path)) == ["000_C_6agents.png", "001_A_6agents.png"]


def test_example_runs_on_the_cpu(tmp_path, capsys):
    assert example_torch.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    # the external agent's constant action turns it in circles: the episode
    # runs all 100 steps, as in the JAX example
    assert out == [f"saved {tmp_path / '100_2agents.png'}", "Experiment over."]
    assert os.listdir(tmp_path) == ["100_2agents.png"]


def test_curriculum_script_runs_the_jax_stages_through_the_port():
    def stages(name):
        text = open(os.path.join(REPO, "scripts", name)).read()
        common = re.search(r'^COMMON="(.*)"$', text, re.M).group(1)
        specs = re.findall(r'"(\d+ \d+ \d+ \d+ ?[^"]*)"', text)
        return common, [s.replace("tpu_curriculum", "D").replace("torch_curriculum", "D")
                        for s in specs], text
    common, specs, text = stages("train_curriculum_torch.sh")
    assert (common, specs) == stages("train_curriculum.sh")[:2] and len(specs) == 6
    assert "python scripts/train_ppo_torch.py $COMMON" in text
    assert "--export-params" in text and "--init-params" in text
    assert subprocess.run(["bash", "-n", os.path.join(REPO, "scripts",
                                                      "train_curriculum_torch.sh")]).returncode == 0
