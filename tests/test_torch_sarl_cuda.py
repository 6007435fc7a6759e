"""SARL's path on the card against the CPU.  Imports neither JAX nor
``tests/conftest.py``'s setup, so it runs on a machine with a CUDA card and
no JAX::

    python -m pytest --noconftest -q -s tests/test_torch_sarl_cuda.py

Without a card every case skips.  On mid-episode states of the ``sarl6``
path at [256, 6] (1 990 656 candidate rows, 9 953 280 pairs), the value
net's raw outputs in float32 on the card with TF32 off lie within 1e-5 of
the CPU's (the card's kernel and the CPU's products sum the same float32
terms in other orders, about 1e-7 apart on these values), and the actions
are equal except where the CPU's two best candidates lie within that
distance.  With TF32 on, how far the outputs move and how many actions
change is printed, not held: the value net runs as one hand-written kernel
on the card (``csrc/sarl_value.cu``, FP32 FMAs on the CUDA cores), which
TF32 does not touch.

The kernel itself is held against ``forward_raw_plain`` on the card at A =
2, 6 and 20 (its tiles then hold 128, 25 and 6 candidate rows), with others
absent, rows with none present and pairs whose score is exactly 0, in
float32 within 1e-5 and float64 within 1e-12; equal rows give equal bits
wherever they sit and whatever R is; a SARL policy step on the card is one
launch of it, and a CPU tensor none.  ``chip_smoke.py`` loads this file for
the same cases.
"""

import math

import pytest
import torch

from gym_collision_avoidance_torch import ops
from gym_collision_avoidance_torch.harness import paths
from gym_collision_avoidance_torch.models import sarl
from gym_collision_avoidance_torch.policies import sarl as sarl_policy

pytestmark = pytest.mark.cuda
TOL = 1e-5
# the kernel against the plain version, by dtype
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(path, state, monkeypatch):
    """``(raw [E, A, 81], values, actions)`` of one policy call, the raw
    values recorded from ``models.sarl.forward_raw``."""
    calls = []
    orig = sarl.forward_raw

    def recorded(*args):
        calls.append(orig(*args))
        return calls[-1]

    monkeypatch.setattr(sarl, "forward_raw", recorded)
    values, _ = sarl_policy.sarl_values(state, path.cfg, path.params)
    actions = sarl_policy.sarl_kernel(state, path.cfg, path.params)
    return calls[0].cpu(), values.cpu(), actions.cpu()


def _gap(values):
    top = values.amax(dim=-1, keepdim=True)
    second = torch.where(values < top, values, -math.inf).amax(dim=-1)
    return top[..., 0] - second


def test_card_values_match_the_cpu(cuda_device, monkeypatch):
    cpu_path = paths.serving_path("sarl6", "cpu")
    state, cases = paths.mid_episode_states(cpu_path, 256, 5, "cpu")
    assert cases == 256
    raw, values, actions = _run(cpu_path, state, monkeypatch)
    card = cpu_path.to(cuda_device)
    on_card = state.to(cuda_device)
    allow = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        raw_c, values_c, actions_c = _run(card, on_card, monkeypatch)
        err = float((raw_c - raw).abs().max())
        same = (actions_c == actions).all(dim=-1)
        print(f"\nsarl [256, 6] TF32 off: max |raw - cpu| {err:.3e}, "
              f"{int((~same).sum())} of {same.numel()} actions differ")
        assert err < TOL and float((values_c - values).abs().max()) < TOL
        assert bool((same | (_gap(values) < TOL)).all())

        torch.backends.cuda.matmul.allow_tf32 = True
        raw_t, _, actions_t = _run(card, on_card, monkeypatch)
        same_t = (actions_t == actions).all(dim=-1)
        print(f"sarl [256, 6] TF32 on: max |raw - cpu| "
              f"{float((raw_t - raw).abs().max()):.3e}, "
              f"{int((~same_t).sum())} of {same_t.numel()} actions differ")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def test_the_server_steps_on_the_card(cuda_device):
    path = paths.serving_path("sarl6", cuda_device)
    server = path.server(num_envs=64, steps_per_dispatch=4)
    for _ in range(2):
        out = server.dispatch()
        assert torch.isfinite(out["mean_reward"]).all()
        assert torch.isfinite(out["obs_checksum"]).all()
    assert server.states().pos.device.type == "cuda"


def kernel_inputs(dtype, E, A, seed, device):
    """Seeded ``(pairs [E, A, 81, A - 1, 13], present [E, A, 1, A - 1],
    self_state [E, A, 81, 6])`` on ``device``: about a fifth of the others
    absent, every other absent for agent 0 of env 0, every one present for
    agent 1 of env 0."""
    g = torch.Generator().manual_seed(seed)
    P = A - 1
    pairs = torch.randn(E, A, 81, P, 13, generator=g, dtype=torch.float64) * 2.0
    self_state = torch.randn(E, A, 81, 6, generator=g, dtype=torch.float64)
    present = torch.rand(E, A, 1, P, generator=g) < 0.8
    present[0, 0] = False
    present[0, 1] = True
    return (pairs.to(dtype).to(device), present.to(device), self_state.to(dtype).to(device))


def attention_unit(net, inputs, unit=0):
    """``([R, P] pre-activations of attention.2's unit ``unit``, [R, P]
    present)``, as the plain version computes them."""
    pairs, present, _ = inputs
    P = pairs.shape[-2]
    e = net.mlp1(pairs.reshape(-1, P, 13))
    there = present.expand(*pairs.shape[:-1]).reshape(-1, P, 1)
    m = torch.where(there, e, 0.0).sum(dim=1) / there.sum(dim=1).clamp(min=1)
    w = net.attention[0].weight
    a1 = torch.relu(e @ w[:, :100].T + (m @ w[:, 100:].T + net.attention[0].bias)[:, None])
    return net.attention[2](a1)[..., unit], there[..., 0]


def zero_score_net(dtype, device, inputs):
    """The seeded net with its score read from one ReLU unit of attention.2
    (attention.4's weight one-hot, its bias 0), that unit's bias moved so
    that about half of the present pairs of ``inputs`` have it off: they
    score exactly 0 and drop out of the softmax.  The cut lies in the widest
    gap between the pre-activations near their median, so that no pair sits
    within a rounding of the ReLU's kink, where the kernel's and the plain
    version's sums, which round differently, could put it on either side."""
    net = sarl.load_params(dtype=dtype, device=device)
    with torch.no_grad():
        pre, there = attention_unit(net, inputs)
        near = pre[there].sort().values
        mid = near.numel() // 2
        near = near[max(mid - 1000, 0):mid + 1000]
        gap = int((near[1:] - near[:-1]).argmax())
        net.attention[2].bias[0] -= (near[gap] + near[gap + 1]) / 2
        net.attention[4].weight.zero_()
        net.attention[4].weight[0, 0] = 1.0
        net.attention[4].bias.zero_()
    return net


def hold_kernel(net, inputs):
    """``(kernel, plain, max |kernel - plain|)``, holding one launch a call."""
    before = ops.launch_counts()["sarl_value"]
    got = sarl.forward_raw(net, *inputs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sarl_value"] == before + 1
    want = sarl.forward_raw_plain(net, *inputs)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    return got, want, float((got - want).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("A", [2, 6, 20])
def test_kernel_matches_the_plain_net(cuda_device, dtype, A):
    net = sarl.load_params(dtype=dtype, device=cuda_device)
    _, _, err = hold_kernel(net, kernel_inputs(dtype, 5, A, A, cuda_device))
    print(f"\nK7 {str(dtype)[6:]} A={A}: max |kernel - plain| {err:.3g}")
    assert err <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_drops_pairs_that_score_zero(cuda_device, dtype):
    inputs = kernel_inputs(dtype, 4, 6, 7, cuda_device)
    net = zero_score_net(dtype, cuda_device, inputs)
    with torch.no_grad():
        pre, there = attention_unit(net, inputs)
    zero = float((pre[there] <= 0).double().mean())
    assert 0.3 < zero < 0.7 and float(pre[there].abs().min()) > 3e-5
    _, _, err = hold_kernel(net, inputs)
    assert err <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_equal_rows_give_equal_bits_wherever_they_sit(cuda_device, dtype):
    net = sarl.load_params(dtype=dtype, device=cuda_device)
    pairs, present, self_state = kernel_inputs(dtype, 4, 6, 3, cuda_device)
    rows = pairs.reshape(-1, 5, 13)
    selfs = self_state.reshape(-1, 6)
    mask = present.expand(4, 6, 81, 5).reshape(-1, 5).contiguous()
    one = sarl.forward_raw(net, rows[7:8], mask[7:8], selfs[7:8])
    for R, at in ((rows.shape[0], [0, 24, 25, 26, 1000, rows.shape[0] - 1]), (31, [3, 30]),
                  (1, [0])):
        x, s, m = rows[:R].clone(), selfs[:R].clone(), mask[:R].clone()
        x[at], s[at], m[at] = rows[7], selfs[7], mask[7]
        got = sarl.forward_raw(net, x, m, s)
        assert bool((got[at] == one[0]).all()), (R, at)


def test_a_policy_step_is_one_launch(cuda_device):
    path = paths.serving_path("sarl6", cuda_device)
    state, _ = paths.mid_episode_states(path, 16, 2, cuda_device)
    before = ops.launch_counts()["sarl_value"]
    sarl_policy.sarl_kernel(state, path.cfg, path.params)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sarl_value"] == before + 1
    cpu = paths.serving_path("sarl6", "cpu")
    sarl_policy.sarl_kernel(state.to("cpu"), cpu.cfg, cpu.params)
    assert ops.launch_counts()["sarl_value"] == before + 1
