"""The port stands alone: importing every module of
``gym_collision_avoidance_torch`` pulls in neither jax nor the JAX package,
and its entry points refuse to fall back to the CPU when CUDA is absent."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_IMPORT_ALL = """
import importlib, pkgutil, sys
import gym_collision_avoidance_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
for name in ("maps.grid", "ops.pairwise", "ops.raymarch", "ops.laser_fused", "ops.build",
             "obs.sensors", "env.step", "harness.serving", "convert", "models.ga3c_cadrl",
             "policies.ga3c", "ops.orca", "policies.rvo", "core.prng", "models.cadrl",
             "policies.cadrl", "models.drl_long", "policies.drl_long", "harness.paths",
             "train.ppo", "train.optim", "utils.checkpoint", "scenarios.suites",
             "harness.experiments", "harness.registry", "harness.datasets",
             "harness.visualize", "env.gymapi", "obs.wrappers"):
    assert pkg.__name__ + "." + name in sys.modules, name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gym_collision_avoidance_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=repo_root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` runs on a machine without JAX, and loads K2's and
    K3's band models from ``tests/test_torch_raymarch_band.py`` and
    ``tests/test_torch_laser_fused_band.py``."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, chip_smoke\n"
            "chip_smoke.band_model('raymarch'); chip_smoke.band_model('laser_fused')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gym_collision_avoidance_tpu'))\n"
            "assert not bad, bad\nprint('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_training_cli_imports_no_jax():
    """``scripts/train_ppo_torch.py`` trains an iteration on the CPU without
    importing jax or the JAX package."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('cli', 'scripts/train_ppo_torch.py')\n"
            "cli = importlib.util.module_from_spec(spec); spec.loader.exec_module(cli)\n"
            "assert cli.main(['--device', 'cpu', '--iters', '1', '--envs', '4', '--horizon', '2',"
            " '--pool-cases', '4']) == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gym_collision_avoidance_tpu'))\n"
            "assert not bad, bad\nprint('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


_WITHOUT_OPTIONAL = """
import importlib, importlib.util, pkgutil, sys, tempfile

BLOCKED = ("pandas", "matplotlib", "imageio", "gymnasium")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
import gym_collision_avoidance_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
from gym_collision_avoidance_torch.env import gymapi
assert gymapi.CollisionAvoidanceEnv.__mro__[1] is object
import chip_smoke
spec = importlib.util.spec_from_file_location("cli", "scripts/run_full_test_suite_torch.py")
cli = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cli)
with tempfile.TemporaryDirectory() as out:
    assert cli.main(["--device", "cpu", "--agents", "2", "--policies", "RVO", "--cases", "3",
                     "--out", out]) == 0
    assert cli.main(["--device", "cpu", "--agents", "2", "--policies", "RVO", "--cases", "3",
                     "--out", out, "--record-pickles"]) == 2
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "gym_collision_avoidance_tpu") + BLOCKED)
assert not bad, bad
print("ok")
"""


def test_port_imports_without_pandas_matplotlib_imageio_gymnasium():
    """The card's machine has none of the four: every module of the port,
    ``chip_smoke.py`` and ``scripts/run_full_test_suite_torch.py`` import
    with them blocked, the CLI runs a tiny campaign on the CPU (and refuses
    ``--record-pickles``), and nothing imports jax."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_OPTIONAL], cwd=repo_root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from gym_collision_avoidance_torch import EnvConfig, init_state
    from gym_collision_avoidance_torch.env import autoreset
    from gym_collision_avoidance_torch.harness import runner
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer
    from gym_collision_avoidance_torch.scenarios import random_cases

    cfg = EnvConfig(dtype="float32")
    pool = random_cases.scenario_pool(4, 4, seed=0)
    pid = np.full(4, 2, np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoresetServer(cfg, pool, pid, num_envs=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autoreset.state_from_case(cfg, pool, pid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(cfg, pool[..., 0:2], pool[..., 2:4], pool[..., 5], pool[..., 4])
    st = autoreset.state_from_case(cfg, pool, pid, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.rollout(st, cfg, 1)


def test_trainer_and_cli_default_to_cuda_and_raise_without_it(no_cuda):
    from gym_collision_avoidance_torch.train import PPOConfig, make_ppo

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_ppo(PPOConfig(num_envs=4, horizon=2))
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "scripts/train_ppo_torch.py", "--iters", "1"],
                          cwd=repo_root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


def test_policy_ids_6_and_8_are_ported():
    """Every internal policy has a kernel: GA3C-CADRL (6), SA-CADRL (7), RVO
    (8) and DRL-Long (9), under the JAX package's registry names."""
    from gym_collision_avoidance_torch.policies import cadrl, drl_long, ga3c, registry, rvo

    assert registry.internal_kernel(registry.GA3C_CADRL) is ga3c.ga3c_cadrl_kernel
    assert registry.internal_kernel(registry.CADRL) is cadrl.cadrl_kernel
    assert registry.internal_kernel(registry.RVO) is rvo.rvo_kernel
    assert registry.internal_kernel(registry.DRL_LONG) is drl_long.drl_long_kernel
    assert registry.POLICY_NAMES["CADRL"] == 7 and registry.POLICY_NAMES["drllong"] == 9
    assert registry.UNPORTED_POLICIES == {}
    with pytest.raises(NotImplementedError, match="no kernel"):
        registry.internal_kernel(registry.EXTERNAL)


def test_cadrl_and_drl_long_weights_load_without_cuda_only_on_request(no_cuda):
    from gym_collision_avoidance_torch.models import cadrl, drl_long

    for load in (cadrl.load_params, drl_long.load_params, drl_long.init_params,
                 drl_long.init_actor_critic_params):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load()
    assert cadrl.load_params(device="cpu").W0.device.type == "cpu"
    net = drl_long.load_params(device="cpu")
    assert net.has_critic and net.fc1.in_features == 4096


def test_ga3c_weights_load_without_cuda_only_on_request(no_cuda):
    from gym_collision_avoidance_torch.models import ga3c_cadrl

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ga3c_cadrl.load_params()
    net = ga3c_cadrl.load_params("ppo_selfplay_4agent_curr", device="cpu")
    assert net.width == 26 and net.lstm_kernel.device.type == "cpu"


def test_harness_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from gym_collision_avoidance_torch import EnvConfig
    from gym_collision_avoidance_torch.env.gymapi import CollisionAvoidanceEnv
    from gym_collision_avoidance_torch.harness import datasets, experiments, registry

    cfg = EnvConfig.evaluate(dtype="float32")
    scenarios = experiments.suite_scenarios(2, "RVO", 2)
    for call in (lambda: experiments.run_batched_episodes(scenarios, cfg),
                 lambda: experiments.run_suite_cell(2, "RVO", 2),
                 lambda: registry.load_params("ga3c_cadrl"),
                 lambda: CollisionAvoidanceEnv(cfg=cfg),
                 lambda: datasets.collect_trajectory_dataset(1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "scripts/run_full_test_suite_torch.py", "--cases", "2",
                           "--agents", "2", "--policies", "RVO", "--out", "/nonexistent/x"],
                          cwd=repo_root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
