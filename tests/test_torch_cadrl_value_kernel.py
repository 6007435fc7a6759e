"""SA-CADRL's value-net kernel (``ops/cadrl_value.py``, ``csrc/cadrl_value.cu``)
on the CPU: what surrounds the launch.

A CPU tensor takes the plain version and launches nothing; the packed
weights the kernel reads unpack to the net's own, for both checkpoints and
dtypes, are packed once, and are packed again after any change of a weight
(``load_state_dict``, ``p.data = ...``, ``copy_``, ``.double()``, a deep
copy); the SA-CADRL policy reaches the net
only through ``models.cadrl.forward_raw`` (the name the benchmark's recorder
wraps) with contiguous rows of the net's dtype, which the kernel's wrapper
requires; and the benchmark's ``cadrl_value_roofline`` reader.  The kernel
itself is held against the plain version on the card by
``tests/test_torch_policies_cuda.py``.
"""

import copy
import importlib.util
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig, init_state, ops
from gym_collision_avoidance_torch.models import cadrl
from gym_collision_avoidance_torch.ops import cadrl_value
from gym_collision_avoidance_torch.policies import cadrl as cadrl_policy
from gym_collision_avoidance_torch.policies import registry

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


def _rows(net, seed, shape):
    """Seeded ``[*shape, 31]`` rows about the net's input statistics."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, 31) * net.std_vec.double().numpy() + net.avg_vec.double().numpy()
    return torch.as_tensor(x, dtype=net.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensor_takes_the_plain_version(dtype):
    before = ops.launch_counts()["cadrl_value"]
    net = cadrl.load_params(dtype=dtype, device="cpu")
    x = _rows(net, 0, (2, 4, 47))
    got = cadrl.forward_raw(net, x)
    assert got.shape == (2, 4, 47) and got.dtype == dtype
    assert torch.equal(got, cadrl.forward_raw_plain(net, x))
    assert torch.equal(net.forward_raw(x), got)
    assert ops.launch_counts()["cadrl_value"] == before
    with pytest.raises(ValueError, match="no CADRL value net"):
        cadrl.forward_raw(net, x.to("meta"))


SHAPES = dict(cadrl_value.WIDTHS, b0=(200,), b1=(200,), b3=(50,), b4=(1,), avg_vec=(31,),
              inv_std=(31,), output_std=(1,), output_avg=(1,))


def _unpack(packed):
    """``{name: tensor}`` back from ``cadrl_value.pack``'s buffer, read by
    the layout the kernel's source note gives."""
    out, at = {}, 0
    for name, size in cadrl_value.LAYOUT:
        piece, shape = packed[at:at + size], SHAPES[name]
        at += size
        if name in cadrl_value.GROUPS:
            cols, pad = cadrl_value.GROUPS[name]
            piece = piece.reshape(shape[0], -1, pad)[..., :cols]
        out[name] = piece.reshape(-1)[:math.prod(shape)].reshape(shape)
    assert at == packed.numel()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("checkpoint", list(cadrl.CHECKPOINTS))
def test_packed_weights_unpack_exactly(checkpoint, dtype):
    net = cadrl.load_params(checkpoint, dtype=dtype, device="cpu")
    packed = cadrl_value.packed(net)
    assert packed.dtype == dtype
    assert packed.numel() == sum(size for _name, size in cadrl_value.LAYOUT) == 58324
    assert not any(t is packed for t in net.state_dict().values())
    got = _unpack(packed)
    assert sorted(got) == sorted(name for name, _size in cadrl_value.LAYOUT)
    for name, tensor in got.items():
        want = getattr(net, name)
        assert tensor.shape == want.shape and torch.equal(tensor, want), name
    # the padding is zeros
    assert torch.equal(cadrl_value.pack(got), packed)
    grouped = packed[:200 * 8 * 28].reshape(200, 8, 28)
    assert not grouped[..., 25:].any()
    # W1's row 3, columns 25-49, by hand: group 1 starts 28 elements into the row
    assert torch.equal(packed[3 * 224 + 28:3 * 224 + 53], net.W1[3, 25:50])


def _follows(net):
    assert torch.equal(cadrl_value.packed(net), cadrl_value.pack(
        {name: getattr(net, name) for name, _size in cadrl_value.LAYOUT}))


def test_packed_weights_follow_the_state_dict():
    """The kernel's copy of the weights is packed once, and again after
    every change of a weight, however it is made."""
    net = cadrl.load_params(device="cpu")
    other = cadrl.load_params("rotate_constr_right", device="cpu")
    first = cadrl_value.packed(net)
    assert cadrl_value.packed(net) is first
    net.load_state_dict(other.state_dict())
    assert torch.equal(cadrl_value.packed(net), cadrl_value.packed(other))
    # the benchmark's bf16_weights control
    for p in net.parameters():
        p.data = p.data.to(torch.bfloat16).to(p.dtype)
    assert not torch.equal(cadrl_value.packed(net), cadrl_value.packed(other))
    _follows(net)
    with torch.no_grad():
        net.W1.copy_(other.W1)
        net.b4.add_(1.0)
        net.avg_vec[0] = 7.0
    _follows(net)
    twin = copy.deepcopy(net)
    with torch.no_grad():
        twin.W0.mul_(2.0)
    _follows(twin)
    _follows(net)
    assert not torch.equal(cadrl_value.packed(net.double()), cadrl_value.packed(twin.double()))
    _follows(net)
    assert cadrl_value.packed(net).dtype == torch.float64


def _states(seed, E):
    rng = np.random.RandomState(seed)
    cfg = EnvConfig(dtype="float32")
    st = init_state(cfg, rng.uniform(-4, 4, (E, 4, 2)), rng.uniform(-4, 4, (E, 4, 2)),
                    rng.uniform(0.2, 0.6, (E, 4)), rng.uniform(0.5, 1.5, (E, 4)),
                    heading=rng.uniform(-np.pi, np.pi, (E, 4)),
                    policy_id=np.full((E, 4), registry.CADRL, np.int32), device="cpu")
    return cfg, st.replace(vel=torch.as_tensor(rng.uniform(-1, 1, (E, 4, 2)),
                                               dtype=torch.float32))


@pytest.mark.parametrize("checkpoint", list(cadrl.CHECKPOINTS))
@pytest.mark.parametrize("entry", ["cadrl_kernel", "cadrl_values", "cadrl_state_values"])
def test_policy_reaches_the_net_through_forward_raw(entry, checkpoint, monkeypatch):
    """Every call of the net goes through the module attribute, so a wrapper
    installed there (the benchmark's recorder) sees it, with rows the
    kernel's wrapper takes: contiguous, of the net's dtype."""
    cfg, st = _states(1, 3)
    if checkpoint == "rotate_constr_right":
        cfg = cfg.replace(cadrl_mode="rotate_constr", cadrl_passing_side="right")
    net = cadrl.load_params(checkpoint, device="cpu")
    calls = []
    plain = cadrl.forward_raw_plain

    def recorded(params, x):
        calls.append((params, x.is_contiguous(), x.dtype, tuple(x.shape)))
        return plain(params, x)

    def hidden(params, x):
        raise AssertionError("the policy called the plain version by name")

    monkeypatch.setattr(cadrl, "forward_raw", recorded)
    monkeypatch.setattr(cadrl, "forward_raw_plain", hidden)
    getattr(cadrl_policy, entry)(st, cfg, {"cadrl": net})
    assert len(calls) == 1
    params, contiguous, dtype, shape = calls[0]
    assert params is net and contiguous and dtype == net.dtype
    candidates = 38 if checkpoint == "rotate_constr_right" else 47
    assert shape == ((3, 4, 31) if entry == "cadrl_state_values" else (3, 4, candidates, 31))


def _roofline_reader():
    path = ROOT / "perfbench" / "metrics" / "cadrl_value_roofline.py"
    spec = importlib.util.spec_from_file_location("cadrl_value_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _run(kernels, device_kind=H100):
    config = json.loads((ROOT / "perfbench" / "configs" / "cadrl4.json").read_text())
    trace = types.SimpleNamespace(kernels=kernels, steps=len(kernels))
    return types.SimpleNamespace(config=config, num_envs=16384, num_agents=4, trace=trace,
                                 device_kind=device_kind)


def test_cadrl_value_roofline_reader():
    read = _roofline_reader()
    name = "void (anonymous namespace)::cadrl_value_gemm_kernel<float, 128, 20>(...)"
    assert read(_run([])) is None
    assert read(_run([("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 0.0, 0.01)])) is None
    assert read(_run([(name, 0.0, 0.01)], device_kind="cpu")) is None
    # 3 080 192 rows x 102 500 operations at 67 TFLOP/s is 4.712 ms; two
    # launches of 9.424 ms on average (one beside another kernel) read 50%
    rows = 16384 * 4 * 47
    bound_s = rows * 102_500 / 67e12
    kernels = [(name, 0.0, 0.009), ("elementwise_kernel", 0.009, 0.010),
               (name, 0.010, 0.010 + 2 * 2 * bound_s - 0.009)]
    assert read(_run(kernels)) == pytest.approx(50.0)
