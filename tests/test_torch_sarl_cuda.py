"""SARL's path on the card against the CPU.  Imports neither JAX nor
``tests/conftest.py``'s setup, so it runs on a machine with a CUDA card and
no JAX::

    python -m pytest --noconftest -q -s tests/test_torch_sarl_cuda.py

Without a card every case skips.  On mid-episode states of the ``sarl6``
path at [256, 6] (1 990 656 candidate rows, 9 953 280 pairs), the value
net's raw outputs in float32 on the card with TF32 off lie within 1e-5 of
the CPU's (cuBLAS and the CPU's products sum the same float32 terms in
other orders, about 1e-7 apart on these values), and the actions are equal
except where the CPU's two best candidates lie within that distance.  With
TF32 on, how far the outputs move and how many actions change is printed,
not held: TF32 rounds the products' operands to 10 bits, which is what the
benchmark's TF32 control must catch.
"""

import math

import pytest
import torch

from gym_collision_avoidance_torch.harness import paths
from gym_collision_avoidance_torch.models import sarl
from gym_collision_avoidance_torch.policies import sarl as sarl_policy

pytestmark = pytest.mark.cuda
TOL = 1e-5


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
