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
             "harness.visualize", "env.gymapi", "obs.wrappers", "parallel.mesh",
             "parallel.distributed", "utils.profiling", "entry"):
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
    ``tests/test_torch_laser_fused_band.py``, K6's cases from
    ``tests/test_torch_cadrl_lookahead_kernel.py`` and K7's from
    ``tests/test_torch_sarl_cuda.py``."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, chip_smoke\n"
            "chip_smoke.band_model('raymarch'); chip_smoke.band_model('laser_fused')\n"
            "chip_smoke.test_module('test_torch_cadrl_lookahead_kernel')\n"
            "chip_smoke.test_module('test_torch_sarl_cuda')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gym_collision_avoidance_tpu'))\n"
            "assert not bad, bad\nprint('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _declared_kernels():
    """Every ``build.Kernel`` that a module of ``ops/`` declares."""
    import importlib

    from gym_collision_avoidance_torch.ops import build

    mods = [importlib.import_module(f"gym_collision_avoidance_torch.ops.{p.stem}")
            for p in build.PACKAGE_DIR.joinpath("ops").glob("*.py")]
    return [k for m in mods for k in vars(m).values() if isinstance(k, build.Kernel)]


def test_launch_counts_are_keyed_by_the_csrc_sources():
    """One count a ``csrc/*.cu``, each declared kernel's source among them,
    and a count of 0 launches on the CPU."""
    from gym_collision_avoidance_torch import ops

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csrc = os.path.join(repo_root, "gym_collision_avoidance_torch", "csrc")
    stems = {name[:-3] for name in os.listdir(csrc) if name.endswith(".cu")}
    assert set(ops.launch_counts()) == stems
    assert {k.source for k in _declared_kernels()} == stems
    ops.zero_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(stems, 0)


def test_kernel_refuses_a_dtype_it_lacks_before_building(monkeypatch):
    """A dtype without a symbol raises ``TypeError`` from the launcher, with
    no build, no load and no count, so it needs no nvcc."""
    from gym_collision_avoidance_torch import ops
    from gym_collision_avoidance_torch.ops import build

    def refused(name):
        raise AssertionError(f"{name} was built or loaded")

    monkeypatch.setattr(build, "load", refused)
    counts = ops.launch_counts()
    for kernel in _declared_kernels():
        with pytest.raises(TypeError, match="float32 or float64"):
            kernel.check(torch.float16)
        with pytest.raises(TypeError, match=f"the {kernel.entry} kernel takes"):
            kernel(torch.float16, 0, device=torch.device("cpu"))
        assert torch.float16 not in kernel.funcs
    assert ops.launch_counts() == counts


def test_launcher_imports_no_jax():
    """``scripts/launch_multihost_torch.py`` runs a rank of the distributed
    rollout on the CPU without importing jax or the JAX package."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('launch', "
            "'scripts/launch_multihost_torch.py')\n"
            "launch = importlib.util.module_from_spec(spec); spec.loader.exec_module(launch)\n"
            "assert launch.main(['--device', 'cpu', '--num-envs', '4', '--steps', '2']) == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gym_collision_avoidance_tpu'))\n"
            "assert not bad, bad\nprint('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def test_entry_module_runs_without_jax():
    """``gym_collision_avoidance_torch/entry.py`` (the counterpart of
    ``__graft_entry__.py``) steps its batch and dry-runs one gloo rank on the
    CPU without importing jax or the JAX package."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from gym_collision_avoidance_torch import entry\n"
            "fn, args = entry.entry(device='cpu')\n"
            "states, rewards, game_over = fn(*args)\n"
            "assert tuple(rewards.shape) == (8, 4) and tuple(game_over.shape) == (8,)\n"
            "assert entry.dryrun_multichip(1, device='cpu')[0]['episodes'] > 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gym_collision_avoidance_tpu'))\n"
            "assert not bad, bad\nprint('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


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


# each new entry point's CLI at a tiny size on the CPU: (script, main's
# arguments, with {tmp} a scratch directory)
_DRL_LONG = "gym_collision_avoidance_torch/models/weights/drl_long_2agent_rvo_tpu.npz"
_FLAGSHIP = "gym_collision_avoidance_torch/models/weights/ppo_selfplay_10agent_tpu.npz"
_ENTRY_POINTS = {
    "eval_drl_long_torch": ([_DRL_LONG, "--cases", "2", "--steps", "2"],),
    "eval_trained_net_torch": ([_FLAGSHIP, "--agents", "2", "--cases", "2"],),
    "train_example_torch": (["--iters", "1", "--envs", "8", "--horizon", "2"],),
    "example_torch": (["--out", "{tmp}"],),
    "run_cadrl_formations_torch": (["--episodes", "1", "--out", "{tmp}"],),
    "run_trajectory_dataset_creator_torch": (["--trajs", "1", "--out", "{tmp}/trajs.p"],),
    "collect_regression_dataset_torch": (["--train", "2", "--test", "2", "--agents", "2",
                                          "--out", "{tmp}"],),
    # the benchmark at a tiny size (bench_torch.py sits at the root)
    "bench_torch": (["--envs-divisor", "256", "--steps", "2"],),
    "bench_all_torch": (["--envs", "32", "--steps", "2"],),
    # the multi-device entry points at their smallest size, on 1 gloo rank
    "scaling_bench_torch": (["--max-ranks", "1", "--envs-per-device", "2", "--steps", "2",
                             "--reps", "1", "--out", "{tmp}/scaling.md"],),
    "collective_overhead_torch": (["--ranks", "1", "--ppo-envs", "4", "--envs", "4",
                                   "--steps", "2", "--calls", "2", "--reps", "1"],),
    "scaling_multiproc_torch": (["--ranks", "1", "--envs", "4", "--steps", "2",
                                 "--reps", "1"],),
}
_AT_ROOT = ("bench_torch",)
_ENTRY_POINT_NO_JAX = """
import importlib.util, sys, tempfile
spec = importlib.util.spec_from_file_location("cli", "{file}")
cli = importlib.util.module_from_spec(spec); spec.loader.exec_module(cli)
with tempfile.TemporaryDirectory() as tmp:
    args = [[a.replace("{{tmp}}", tmp) for a in x] if isinstance(x, list) else
            x.replace("{{tmp}}", tmp) if isinstance(x, str) else x for x in {args}]
    assert cli.main(*args) in (0, None)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "gym_collision_avoidance_tpu"))
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("script", sorted(_ENTRY_POINTS) + ["regenerate_suites_torch"])
def test_entry_point_cli_imports_no_jax(script):
    """Each of the port's entry-point scripts runs on the CPU without
    importing jax or the JAX package."""
    if script == "regenerate_suites_torch":
        args = ("{tmp}", 0, 2)          # main(out_dir, seed, num_test_cases): host only
    else:
        args = (_ENTRY_POINTS[script][0] + ["--device", "cpu"],)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    file = f"{script}.py" if script in _AT_ROOT else f"scripts/{script}.py"
    code = _ENTRY_POINT_NO_JAX.format(file=file, args=repr(list(args)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


@pytest.mark.parametrize("script", sorted(_ENTRY_POINTS))
def test_entry_point_cli_defaults_to_cuda_and_raises_without_it(no_cuda, script, tmp_path):
    """Without ``--device`` each entry point asks for the card, and raises
    without one (``regenerate_suites_torch.py`` runs on the host only)."""
    import importlib

    cli = importlib.import_module(script if script in _AT_ROOT else f"scripts.{script}")
    argv = [a.replace("{tmp}", str(tmp_path)) for a in _ENTRY_POINTS[script][0]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


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


def test_mesh_and_launcher_default_to_cuda_and_raise_without_it(no_cuda):
    """``make_mesh()``, ``global_mesh()`` and the launcher use the card unless
    told otherwise, and raise without one: no CPU fallback."""
    from gym_collision_avoidance_torch.parallel import distributed, mesh

    for call in (mesh.make_mesh, distributed.global_mesh):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for extra in ([], ["--spawn", "2"]):
        proc = subprocess.run([sys.executable, "scripts/launch_multihost_torch.py",
                               "--num-envs", "4", "--steps", "2", *extra], cwd=repo_root,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr, extra
