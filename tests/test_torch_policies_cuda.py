"""GA3C-CADRL, SA-CADRL, DRL-Long and ORCA on the card against the CPU.

Imports neither JAX nor ``tests/conftest.py``'s setup, so it runs on a
machine with a CUDA card and no JAX::

    python -m pytest --noconftest -q -s tests/test_torch_policies_cuda.py

Without a card every case skips.  The GA3C net in float32 on the card, TF32
off, picks the same action as the float64 net on the CPU for at least 99.9%
of 16384 seeded obs (float32 rounding flips near-ties); with TF32 on the
mismatch count is printed, not held.  ORCA in float32 on mid-episode
``orca4`` states equals the CPU bitwise (its roots are ``maths.sqrt_rn``),
and CUDA's ``torch.sqrt``, which ``sqrt_rn`` keeps on the card, is
correctly rounded in float32 and float64.

SA-CADRL in float32 on the card, TF32 off, on seeded 4-agent states: the
candidate values within atol 1e-4 of the float64 CPU run and the action
index equal for at least 99.9% of agents.  Its value net on the card is one
launch of ``csrc/cadrl_value.cu``: held against the plain version on the
card in float32 and float64 at tile edges and at cadrl4's row counts, two
equal rows give the same bits wherever they sit, a weight replaced or
written in place changes what it computes as it does the plain version's,
the wrapper raises on what the kernel does not take, and one cadrl4 step
launches it once.  DRL-Long's float32 CNN on the
card, TF32 off, within rtol 1e-5 / atol 1e-5 of the CPU on 8192
seeded scans.  With TF32 on, how far each moves is printed, not held.  Its
two convolutions are one launch of ``csrc/drl_long_conv.cu``: held against
the plain version (cuDNN) in float32 and float64 at ragged row counts, at
512 beams and a ragged length, the first and last output positions (conv2's
zero padding) apart, and bitwise in float32 at 512 beams; the wrapper
raises on what the kernel does not take; a ``forward`` launches it once,
and once a step on a server configured as the benchmark's ``drl_long4``; a
net that requires gradients launches nothing and trains through cuDNN.
"""

import json
from pathlib import Path


import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig
from gym_collision_avoidance_torch.env import autoreset
from gym_collision_avoidance_torch import init_state
from gym_collision_avoidance_torch.harness import paths
from gym_collision_avoidance_torch.harness.serving import AutoresetServer
from gym_collision_avoidance_torch.models import cadrl, drl_long, ga3c_cadrl
from gym_collision_avoidance_torch.ops import cadrl_value, drl_long_conv, orca
from gym_collision_avoidance_torch.policies import cadrl as cadrl_policy
from gym_collision_avoidance_torch.policies import registry, rvo
from gym_collision_avoidance_torch.scenarios import random_cases


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _obs(seed, B, width=138):
    """Seeded raw obs of the network's layout, 0 to 19 others visible."""
    rng = np.random.RandomState(seed)
    K = (width - 5) // 7
    x = np.zeros((B, width), np.float32)
    x[:, 0] = rng.randint(0, K + 1, B)
    x[:, 1] = rng.uniform(0.0, 10.0, B)
    x[:, 2] = rng.uniform(-np.pi, np.pi, B)
    x[:, 3] = rng.uniform(0.5, 1.5, B)
    x[:, 4] = rng.uniform(0.2, 0.6, B)
    lo = np.array([-5, -5, -1, -1, 0.2, 0.4, 0.0])
    hi = np.array([5, 5, 1, 1, 0.6, 1.2, 8.0])
    others = rng.uniform(lo, hi, (B, K, 7))
    others[np.arange(K)[None, :] >= x[:, :1]] = 0.0
    x[:, 5:] = others.reshape(B, -1)
    return torch.as_tensor(x)


@pytest.mark.cuda
def test_ga3c_card_matches_cpu_float64(cuda_device):
    x = _obs(0, 16384)
    want, _ = ga3c_cadrl.forward(ga3c_cadrl.load_params(dtype=torch.float64, device="cpu"),
                                 x.double())
    net = ga3c_cadrl.load_params(device=cuda_device)
    assert not torch.backends.cuda.matmul.allow_tf32
    got, _ = ga3c_cadrl.forward(net, x.to(cuda_device))
    agree = (got.argmax(-1).cpu() == want.argmax(-1)).double().mean().item()
    assert agree >= 0.999, agree
    torch.testing.assert_close(got.cpu().double(), want, rtol=0, atol=1e-5)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, _ = ga3c_cadrl.forward(net, x.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    mismatched = int((tf32.argmax(-1).cpu() != want.argmax(-1)).sum())
    print(f"\nGA3C float32 on {torch.cuda.get_device_name(0)}: "
          f"{int((got.argmax(-1).cpu() != want.argmax(-1)).sum())} of 16384 argmax mismatches "
          f"with TF32 off, {mismatched} with TF32 on; largest prob difference with TF32 on "
          f"{float((tf32.cpu().double() - want).abs().max()):.3g}")


@pytest.mark.cuda
def test_orca_card_matches_cpu_float32(cuda_device):
    cfg = EnvConfig(dtype="float32", done_mode="evaluate")
    pool = random_cases.scenario_pool(64, 4, seed=0, side_length=4.0)
    pid = np.full(4, registry.RVO, np.int32)
    E = 4096
    step = autoreset.make_autoreset_step(cfg, pool, pid, (registry.RVO,), device=cuda_device)
    st = autoreset.state_from_case(cfg, pool[np.arange(E) % 64], pid, device=cuda_device)
    c = torch.arange(E, dtype=torch.int32, device=cuda_device)
    for _ in range(12):
        st, c = step(st, c)[:2]
    got, branch = orca.orca_solve(*rvo.orca_inputs(st, cfg, None))
    want, want_branch = orca.orca_solve(*rvo.orca_inputs(st.to("cpu"), cfg, None))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert torch.equal(branch.cpu(), want_branch)
    print(f"\nORCA float32 on {torch.cuda.get_device_name(0)}: largest difference "
          f"{float((got.cpu() - want).abs().max()):.3g}, "
          f"{int((branch.cpu() != want_branch).sum())} of {E * 4} LP branches differ, "
          f"{int((want_branch < 3).sum())} agents in LP3")


@pytest.mark.cuda
def test_cuda_sqrt_is_correctly_rounded(cuda_device):
    rng = np.random.RandomState(0)
    for dtype in (np.float32, np.float64):
        x = np.concatenate([rng.uniform(0, 64, 4_000_000), np.exp(rng.uniform(-80, 80, 1_000_000)),
                            [0.0, np.finfo(dtype).tiny / 4]]).astype(dtype)
        got = torch.sqrt(torch.as_tensor(x, device=cuda_device)).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.uint8), np.sqrt(x).view(np.uint8))


def _tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _cadrl_states(seed, E, device):
    """Seeded 4-agent states with random velocities and past velocities."""
    rng = np.random.RandomState(seed)
    cfg = EnvConfig(dtype="float32")
    st = init_state(cfg, rng.uniform(-4, 4, (E, 4, 2)), rng.uniform(-4, 4, (E, 4, 2)),
                    rng.uniform(0.2, 0.6, (E, 4)), rng.uniform(0.5, 1.5, (E, 4)),
                    heading=rng.uniform(-np.pi, np.pi, (E, 4)),
                    policy_id=np.full((E, 4), registry.CADRL, np.int32), device=device)
    return cfg, st.replace(
        vel=torch.as_tensor(rng.uniform(-1, 1, (E, 4, 2)), dtype=torch.float32, device=device),
        past_vel=torch.as_tensor(rng.uniform(-1, 1, (E, 4, 2, 2)), dtype=torch.float32,
                                 device=device))


@pytest.mark.cuda
def test_cadrl_card_matches_cpu_float32(cuda_device):
    cfg, st = _cadrl_states(0, 4096, cuda_device)
    cpu = st.to("cpu").map(lambda x: x.double() if x.is_floating_point() else x)
    want, _ = cadrl_policy.cadrl_values(
        cpu, cfg.replace(dtype="float64"),
        {"cadrl": cadrl.load_params(dtype=torch.float64, device="cpu")})
    params = {"cadrl": cadrl.load_params(device=cuda_device)}
    assert not torch.backends.cuda.matmul.allow_tf32
    got, _ = cadrl_policy.cadrl_values(st, cfg, params)
    agree = (got.argmax(-1).cpu() == want.argmax(-1)).double().mean().item()
    assert agree >= 0.999, agree
    torch.testing.assert_close(got.cpu().double(), want, rtol=0, atol=1e-4)
    _tf32(True)
    try:
        tf32, _ = cadrl_policy.cadrl_values(st, cfg, params)
    finally:
        _tf32(False)
    print(f"\nSA-CADRL float32 on {torch.cuda.get_device_name(0)}: "
          f"{int((got.argmax(-1).cpu() != want.argmax(-1)).sum())} of {want.shape[0] * 4} "
          f"argmax mismatches with TF32 off (values within "
          f"{float((got.cpu().double() - want).abs().max()):.3g}), "
          f"{int((tf32.argmax(-1).cpu() != want.argmax(-1)).sum())} with TF32 on (values within "
          f"{float((tf32.cpu().double() - want).abs().max()):.3g})")


def _value_rows(net, seed, rows):
    """Seeded ``[rows, 31]`` rows about the net's input statistics."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, 31) * net.std_vec.cpu().numpy() + net.avg_vec.cpu().numpy()
    return torch.as_tensor(x, dtype=net.dtype, device=net.W0.device)


# The kernel sums each product in cuBLAS's order (ops/cadrl_value.py), so at
# cadrl4's row counts it gives the plain version's bits; at other row counts
# cuBLAS may order a product otherwise, and float32 values of order 1 then
# differ by a few roundings, some 1e-7: 1e-5 leaves room and stays far below
# the 1e-4 that the card-vs-CPU test holds.  Float64's roundings are some 1e-16.
VALUE_ATOL = {torch.float32: 1e-5, torch.float64: 1e-12}
CADRL4_ROWS = (4096 * 4 * 47, 16384 * 4 * 47)


# tiles are 128 rows in float32 and 32 in float64 (csrc/cadrl_value.cu)
TILE_EDGES = [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 257]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [*TILE_EDGES, *CADRL4_ROWS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cadrl_value_kernel_matches_plain(cuda_device, dtype, rows):
    net = cadrl.load_params(dtype=dtype, device=cuda_device)
    x = _value_rows(net, rows, rows)
    before = cadrl_value.LAUNCHES
    got = cadrl.forward_raw(net, x)
    torch.cuda.synchronize()
    assert cadrl_value.LAUNCHES == before + 1
    want = cadrl.forward_raw_plain(net, x)
    assert got.shape == (rows,) and got.dtype == dtype
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=VALUE_ATOL[dtype])
    if dtype == torch.float32 and rows in CADRL4_ROWS:
        assert torch.equal(got, want)
    if rows > 10**6:
        print(f"\nSA-CADRL value kernel {dtype} at {rows} rows on "
              f"{torch.cuda.get_device_name(0)}: largest difference from the plain version "
              f"{float((got - want).abs().max()):.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cadrl_value_kernel_equal_rows_equal_bits(cuda_device, dtype):
    """A row's value depends on the row alone: not on where it sits in a
    tile, nor on how many rows there are."""
    net = cadrl.load_params(dtype=dtype, device=cuda_device)
    x = _value_rows(net, 5, 1000)
    # float32 tiles are 128 rows, float64's 32: first, last and next rows of tiles
    places = [0, 1, 3, 31, 32, 33, 63, 64, 95, 96, 127, 128, 129, 255, 256, 257, 500, 998, 999]
    x[places] = x[7].clone()
    got = cadrl.forward_raw(net, x)
    alone = cadrl.forward_raw(net, x[7:8].clone())
    shifted = cadrl.forward_raw(net, x[1:])     # rows not on 16 bytes: copied one by one
    torch.cuda.synchronize()
    assert torch.equal(got[places], got[7].expand(len(places)))
    assert torch.equal(alone, got[7:8])
    assert torch.equal(shifted, got[1:])


@pytest.mark.cuda
def test_cadrl_value_kernel_follows_changed_weights(cuda_device):
    """The kernel reads a packed copy of the weights; a weight replaced
    (``p.data = ...``, as the benchmark's bf16_weights control does) or
    written in place (``copy_``) changes what it computes, as it does the
    plain version's."""
    net = cadrl.load_params(device=cuda_device)
    other = cadrl.load_params("rotate_constr_right", device=cuda_device)
    x = _value_rows(net, 8, CADRL4_ROWS[0])
    before = cadrl.forward_raw(net, x)
    for p in net.parameters():
        p.data = p.data.to(torch.bfloat16).to(p.dtype)
    rounded = cadrl.forward_raw(net, x)
    assert not torch.equal(rounded, before)
    assert torch.equal(rounded, cadrl.forward_raw_plain(net, x))
    with torch.no_grad():
        for name in (*cadrl.WEIGHT_NAMES, *cadrl.NORM_NAMES, "inv_std"):
            getattr(net, name).copy_(getattr(other, name))
    copied = cadrl.forward_raw(net, x)
    assert torch.equal(copied, cadrl.forward_raw_plain(net, x))
    assert torch.equal(copied, cadrl.forward_raw(other, x))


@pytest.mark.cuda
def test_cadrl_value_kernel_raises_on_what_it_does_not_take(cuda_device):
    net = cadrl.load_params(device=cuda_device)
    x = _value_rows(net, 6, 256)
    with pytest.raises(ValueError, match="contiguous"):
        cadrl.forward_raw(net, x.t().contiguous().t())
    with pytest.raises(ValueError, match=r"\[\.\.\., 31\]"):
        cadrl.forward_raw(net, x[:, :30].contiguous())
    with pytest.raises(TypeError, match="float32"):
        cadrl.forward_raw(net, x.double())
    arrays = {k: v.cpu().numpy() for k, v in net.state_dict().items()}
    arrays.update(W1=arrays["W1"][:, :100], b1=arrays["b1"][:100], W3=arrays["W3"][:75])
    narrow = cadrl.CADRLValueNet(arrays).to(cuda_device)
    with pytest.raises(ValueError, match="W1"):
        cadrl.forward_raw(narrow, x)


@pytest.mark.cuda
def test_cadrl4_step_launches_the_value_kernel_once(cuda_device):
    server = paths.serving_path("cadrl4", cuda_device).server(
        num_envs=256, steps_per_dispatch=1, device=cuda_device)
    torch.cuda.synchronize()
    before = cadrl_value.LAUNCHES
    server.dispatch()
    torch.cuda.synchronize()
    assert cadrl_value.LAUNCHES == before + 1


@pytest.mark.cuda
def test_drl_long_card_matches_cpu_float32(cuda_device):
    rng = np.random.RandomState(1)
    B = 8192
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.uniform(-0.5, 0.5, (B, 3, 512)), rng.uniform(-4, 4, (B, 2)),
        rng.uniform(-1, 1, (B, 2)))]
    want = drl_long.forward(drl_long.load_params(device="cpu"), *args)
    net = drl_long.load_params(device=cuda_device)
    assert not torch.backends.cudnn.allow_tf32
    got = drl_long.forward(net, *(a.to(cuda_device) for a in args)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _tf32(True)
    try:
        tf32 = drl_long.forward(net, *(a.to(cuda_device) for a in args)).cpu()
    finally:
        _tf32(False)
    print(f"\nDRL-Long float32 on {torch.cuda.get_device_name(0)}: largest action difference "
          f"{float((got - want).abs().max()):.3g} with TF32 off, "
          f"{float((tf32 - want).abs().max()):.3g} with TF32 on")


# DRL-Long's convolution kernel sums in the order of the cuDNN kernel that the
# plain version runs at 512 beams (csrc/drl_long_conv.cu), so there it gives
# the plain version's bits in float32 at any batch; at other lengths cuDNN may
# choose another kernel, and float32 outputs of order 1 then differ by a few
# roundings, some 1e-7
CONV_TOL = dict(rtol=1e-5, atol=1e-5)


def _conv_net(L, dtype, device):
    net = drl_long.init_params(L, seed=L, dtype=dtype, device=device)
    with torch.no_grad():
        net.conv1.bias.uniform_(0.05, 0.3)    # relu(b1) > 0 where the pad must read 0
    return net


def _scans(seed, B, L, dtype, device):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 3, L)), dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [512, 515])
@pytest.mark.parametrize("B", [1, 7, 8195, 65536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_drl_long_conv_kernel_matches_plain(cuda_device, dtype, B, L):
    net = _conv_net(L, dtype, cuda_device)
    x = _scans(B, B, L, dtype, cuda_device)
    before = drl_long_conv.LAUNCHES
    got = drl_long_conv.drl_long_conv_cuda(net, x)
    torch.cuda.synchronize()
    assert drl_long_conv.LAUNCHES == before + 1
    want = drl_long_conv.drl_long_conv_plain(net, x)
    assert got.shape == want.shape == (B, 32, drl_long_conv.out_len(L)) and got.dtype == dtype
    assert torch.isfinite(got).all()
    # conv2's first and last positions read conv1's zero padding
    torch.testing.assert_close(got[..., 0], want[..., 0], **CONV_TOL)
    torch.testing.assert_close(got[..., -1], want[..., -1], **CONV_TOL)
    torch.testing.assert_close(got, want, **CONV_TOL)
    if dtype == torch.float32 and L == 512:
        assert torch.equal(got, want)
    if B == 65536:
        print(f"\nDRL-Long convolution kernel {dtype} [{B}, 3, {L}] on "
              f"{torch.cuda.get_device_name(0)}: largest difference from the plain version "
              f"{float((got - want).abs().max()):.3g}")


@pytest.mark.cuda
def test_drl_long_conv_kernel_raises_on_what_it_does_not_take(cuda_device):
    net = _conv_net(512, torch.float32, cuda_device)
    x = _scans(0, 8, 512, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        drl_long_conv.drl_long_conv_cuda(net, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match=r"\[B, 3, L\]"):
        drl_long_conv.drl_long_conv_cuda(net, x[:, :2].contiguous())
    with pytest.raises(TypeError, match="float32"):
        drl_long_conv.drl_long_conv_cuda(net, x.double())
    with pytest.raises(ValueError, match="is on"):
        drl_long_conv.drl_long_conv_cuda(net, x.cpu())


@pytest.mark.cuda
def test_drl_long_forward_launches_the_conv_kernel_once(cuda_device):
    net = drl_long.load_params(device=cuda_device)
    x = _scans(1, 4096, 512, torch.float32, cuda_device)
    goal = torch.ones(4096, 2, device=cuda_device)
    speed = torch.zeros(4096, 2, device=cuda_device)
    before = drl_long_conv.LAUNCHES
    mean = drl_long.forward(net, x, goal, speed)
    torch.cuda.synchronize()
    assert drl_long_conv.LAUNCHES == before + 1
    assert mean.shape == (4096, 2) and torch.isfinite(mean).all()
    # a net that requires gradients (the PPO trainer's) stays on cuDNN and autograd
    trainer = drl_long.init_actor_critic_params(512, seed=2, device=cuda_device)
    trainer.requires_grad_(True)
    m, _log_std, value = drl_long.forward_actor_critic(trainer, x, goal, speed)
    (m.sum() + value.sum()).backward()
    torch.cuda.synchronize()
    assert drl_long_conv.LAUNCHES == before + 1
    assert trainer.conv1.weight.grad.abs().sum() > 0


@pytest.mark.cuda
def test_drl_long4_step_launches_the_conv_kernel_once(cuda_device):
    """A server built as the benchmark builds ``drl_long4``'s (its env
    config, the laser alone, the empty map) at 256 envs: one launch a step."""
    root = Path(__file__).resolve().parent.parent
    config = json.loads((root / "perfbench" / "configs" / "drl_long4.json").read_text())
    cfg = EnvConfig(**config["env"])
    world = config["world"]
    static, cells = paths.map_inputs(cfg, cuda_device)
    pool = random_cases.scenario_pool(16, config["num_agents"], seed=5, side_length=4.0)
    server = AutoresetServer(
        cfg, pool, np.full(config["num_agents"], config["policy_id"], np.int32), num_envs=256,
        steps_per_dispatch=2, params={"drl_long": drl_long.load_params(device=cuda_device)},
        device=cuda_device, sensors=tuple(world["sensors"]),
        states_in_obs=tuple(world["states_in_obs"]), static_map=static, static_cells=cells)
    torch.cuda.synchronize()
    before = drl_long_conv.LAUNCHES
    server.dispatch()
    torch.cuda.synchronize()
    assert drl_long_conv.LAUNCHES == before + 2
