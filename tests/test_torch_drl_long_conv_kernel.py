"""DRL-Long's convolution kernel (``ops/drl_long_conv.py``,
``csrc/drl_long_conv.cu``) on the CPU: what surrounds the launch.

The plain version is the net's ``nn.Conv1d`` chain bitwise, so the trunk on
the CPU computes what it did before the kernel; a CPU tensor launches
nothing; a net or scans that ask for a gradient (the PPO trainer's net) stay
on autograd; the DRL-Long policy reaches the net only through
``models.drl_long.forward`` (the name the benchmark's recorder wraps) with
contiguous scans, which the kernel's wrapper requires; and the benchmark's
readers count the kernel by the name the source gives it.  The kernel itself
is held against the plain version on the card by
``tests/test_torch_policies_cuda.py``.
"""

import importlib.util
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gym_collision_avoidance_torch import EnvConfig, init_state
from gym_collision_avoidance_torch.models import drl_long
from gym_collision_avoidance_torch.ops import drl_long_conv
from gym_collision_avoidance_torch.policies import drl_long as drl_long_policy
from gym_collision_avoidance_torch.policies import registry
from gym_collision_avoidance_torch.train import ppo

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


def _net(L, dtype):
    return drl_long.init_params(L, seed=3, dtype=dtype, device="cpu")


def _scans(seed, B, L, dtype):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 3, L)), dtype=dtype)


@pytest.mark.parametrize("L", [512, 64, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_is_the_conv1d_chain(dtype, L):
    """The plain version, and the trunk on the CPU, give the bits of the
    ``nn.Conv1d`` + ReLU chain that the trunk ran before the kernel."""
    net = _net(L, dtype)
    # a bias that keeps the padded ends' relu(b1) > 0, where a wrong pad would show
    with torch.no_grad():
        net.conv1.bias.uniform_(0.1, 0.5)
    x = _scans(L, 9, L, dtype)
    w1, b1, w2, b2 = net.conv1.weight, net.conv1.bias, net.conv2.weight, net.conv2.bias
    want = torch.relu(F.conv1d(torch.relu(F.conv1d(x, w1, b1, stride=2, padding=1)), w2, b2,
                               stride=2, padding=1))
    got = drl_long_conv.drl_long_conv_plain(net, x)
    assert got.shape == (9, 32, drl_long_conv.out_len(L)) == want.shape
    assert torch.equal(got, want)
    goal, speed = torch.ones(9, 2, dtype=dtype), torch.full((9, 2), 0.5, dtype=dtype)
    h = torch.relu(net.fc1(want.reshape(9, -1)))
    trunk = torch.relu(net.fc2(torch.cat([h, goal, speed], dim=-1)))
    assert torch.equal(net.trunk(x, goal, speed), trunk)


@pytest.mark.parametrize("L", [3, 4, 5, 6, 37, 64, 512, 515])
def test_out_len_is_conv1d_s(L):
    net = _net(512, torch.float32)
    assert drl_long_conv.drl_long_conv_plain(net, _scans(0, 1, L, torch.float32)).shape[-1] == \
        drl_long_conv.out_len(L) == drl_long.conv_out_len(drl_long.conv_out_len(L, 5, 2, 1),
                                                            3, 2, 1)


def test_cpu_tensor_launches_nothing(monkeypatch):
    monkeypatch.setattr(drl_long_conv, "LAUNCHES", 0)

    def refused(net, x):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    monkeypatch.setattr(drl_long_conv, "drl_long_conv_cuda", refused)
    net = drl_long.load_params(device="cpu")
    x = _scans(1, 4, 512, torch.float32)
    out = drl_long.forward(net, x, torch.ones(4, 2), torch.zeros(4, 2))
    assert out.shape == (4, 2) and torch.isfinite(out).all()
    assert drl_long_conv.LAUNCHES == 0


def test_a_gradient_keeps_autograd():
    """The kernel has no backward: a net whose convolution weights require a
    gradient (the PPO trainer's), or scans that do, take the ``nn.Conv1d``
    chain, and the gradient reaches the weights through it."""
    served = drl_long.load_params(device="cpu")
    x = _scans(2, 3, 512, torch.float32)
    assert not drl_long_conv.needs_grad(served, x)
    assert drl_long_conv.needs_grad(served, x.clone().requires_grad_(True))
    trainer_net = ppo._DRLLong("cpu", 4 + 3 * 64, 64).net_init(torch.Generator().manual_seed(0))
    x = _scans(2, 3, 64, torch.float32)
    assert drl_long_conv.needs_grad(trainer_net, x)
    for p in (served.conv1.bias, served.conv2.weight):
        p.requires_grad_(True)
        assert drl_long_conv.needs_grad(served, _scans(2, 3, 512, torch.float32))
        p.requires_grad_(False)
    mean, _log_std, value = drl_long.forward_actor_critic(trainer_net, x, torch.ones(3, 2),
                                                          torch.zeros(3, 2))
    (mean.sum() + value.sum()).backward()
    for layer in (trainer_net.conv1, trainer_net.conv2):
        assert layer.weight.grad is not None and layer.weight.grad.abs().sum() > 0


def _laser_states(seed, E, L):
    rng = np.random.RandomState(seed)
    cfg = EnvConfig(dtype="float32", use_static_map=True, laserscan_length=L)
    st = init_state(cfg, rng.uniform(-4, 4, (E, 4, 2)), rng.uniform(-4, 4, (E, 4, 2)),
                    rng.uniform(0.2, 0.6, (E, 4)), rng.uniform(0.5, 1.5, (E, 4)),
                    heading=rng.uniform(-np.pi, np.pi, (E, 4)),
                    policy_id=np.full((E, 4), registry.DRL_LONG, np.int32), device="cpu")
    hist = torch.as_tensor(rng.uniform(0.1, 6.0, tuple(st.laserscan_history.shape)),
                           dtype=torch.float32)
    return cfg, st.replace(laserscan_history=hist)


def test_policy_reaches_the_net_through_forward(monkeypatch):
    """Every call of the net goes through the module attribute, so a wrapper
    installed there (the benchmark's recorder) sees it, with scans the
    kernel's wrapper takes: contiguous ``[E A, 3, L]`` of the net's dtype."""
    cfg, st = _laser_states(4, 3, 64)
    net = drl_long.init_params(64, device="cpu")
    calls = []
    plain = drl_long.forward

    def recorded(params, scans, goal, speed):
        calls.append((params, scans.is_contiguous(), scans.dtype, tuple(scans.shape)))
        return plain(params, scans, goal, speed)

    monkeypatch.setattr(drl_long, "forward", recorded)
    acts = drl_long_policy.drl_long_kernel(st, cfg, {"drl_long": net})
    assert acts.shape == (3, 4, 2)
    assert calls == [(net, True, net.dtype, (12, 3, 64))]


def _reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _run(kernels, steps=1):
    config = json.loads((ROOT / "perfbench" / "configs" / "drl_long4.json").read_text())
    trace = types.SimpleNamespace(kernels=kernels, steps=steps)
    return types.SimpleNamespace(config=config, num_envs=16384, num_agents=4, trace=trace,
                                 device_kind=H100)


def test_readers_count_the_kernel():
    """``drl_long_net_roofline`` and ``policy_gemm_ms_per_step.serve`` count
    the kernel under the name its source gives it: left out, the roofline
    would weigh fc1's product alone against the whole net's bound and read
    above 100%."""
    source = (ROOT / "gym_collision_avoidance_torch" / "csrc" / "drl_long_conv.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*\n?\s*(\w+)\(", source)
    assert names == ["drl_long_conv_gemm_kernel"]
    traced = f"void (anonymous namespace)::{names[0]}<float, 8>(float const*, float const*)"
    roofline, gemm_ms = _reader("drl_long_net_roofline"), _reader("policy_gemm_ms_per_step.serve")
    fc1 = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize256x64x8_stage3_warpsize4x1x1"
    # 65 536 rows x 3 195 456 operations at 67 TFLOP/s: 3.125 ms a step
    bound_s = 16384 * 4 * 3_195_456 / 67e12
    # two steps: the kernel and fc1 take twice the bound each step, beside a bias add
    kernels = [(traced, 0.0, 1.5 * bound_s), (fc1, 1.5 * bound_s, 2 * bound_s),
               ("void at::native::elementwise_kernel<128, 2>", 2 * bound_s, 3 * bound_s),
               (traced, 3 * bound_s, 4.5 * bound_s), (fc1, 4.5 * bound_s, 5 * bound_s)]
    assert roofline(_run(kernels, steps=2)) == pytest.approx(50.0)
    assert gemm_ms(_run(kernels, steps=2)) == pytest.approx(2 * bound_s * 1e3)
