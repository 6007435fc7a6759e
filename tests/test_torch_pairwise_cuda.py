"""K1's CUDA kernel against its plain PyTorch version, on the card: K1
alone (``pairwise_collisions``) and with its reward epilogue, the env
step's whole reward stage in one launch (``pairwise_rewards``).

Imports neither JAX nor ``tests/conftest.py``'s setup, so it runs on a
machine with a CUDA card and no JAX::

    python -m pytest --noconftest -q tests/test_torch_pairwise_cuda.py

Without a card every case skips.  Flags are equal and nearest gaps and
rewards bitwise equal: the kernel does the plain version's IEEE operations
in the same order, without FMA contraction (see ``csrc/pairwise.cu``).
"""

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig, ops
from gym_collision_avoidance_torch.ops import pairwise as tpair

# wiggly turns on, so every branch of the reward chain is taken
REWARD_CFG = EnvConfig(reward_wiggly_behavior=-0.2, wiggly_behavior_threshold=0.3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, E, A, dtype, device, nan):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-3, 3, (E, A, 2))
    radius = rng.uniform(0.3, 1.2, (E, A))
    valid = rng.rand(E, A) > 0.2
    # exactly-touching pairs: a 3-4-5 triangle between agents 0 and 1 with
    # radii summing to 5, so dist == r0 + r1 exactly
    pos[:, 1] = pos[:, 0] + np.array([3.0, 4.0])
    radius[:, 0], radius[:, 1] = 2.0, 3.0
    if nan:
        pos[0, 1, 1] = np.nan
    return (torch.tensor(pos, dtype=dtype, device=device),
            torch.tensor(radius, dtype=dtype, device=device),
            torch.tensor(valid, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,E,A,nan", [
    (torch.float32, 16384, 4, False),
    (torch.float32, 512, 40, False),
    (torch.float64, 64, 4, False),
    (torch.float32, 64, 4, True),
])
def test_cuda_kernel_bitwise_equals_plain(cuda_device, dtype, E, A, nan):
    args = _inputs(5, E, A, dtype, cuda_device, nan)
    before = ops.launch_counts()["pairwise"]
    coll, near = tpair.pairwise_collisions(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise"] == before + 1
    ref_coll, ref_near = tpair.pairwise_collisions_plain(*args)
    assert torch.equal(coll, ref_coll)
    assert torch.equal(torch.isnan(near), torch.isnan(ref_near))
    ok = ~torch.isnan(ref_near)
    itype = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(near[ok].view(itype), ref_near[ok].view(itype))
    if not nan:
        both = args[2][:, 0] & args[2][:, 1]
        assert coll[both, 0].all()


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    pos, radius, valid = _inputs(6, 8, 4, torch.float32, cuda_device, False)
    with pytest.raises(TypeError):
        tpair.pairwise_collisions(pos.half(), radius.half(), valid)
    with pytest.raises(TypeError):
        tpair.pairwise_collisions(pos, radius.double(), valid)
    with pytest.raises(ValueError):
        tpair.pairwise_collisions(pos.transpose(0, 1), radius.t(), valid.t())
    with pytest.raises(ValueError):
        tpair.pairwise_collisions(pos, radius[:, :3], valid)


def _reward_inputs(seed, E, A, dtype, device, nan, wall):
    """``pairwise_rewards``' arguments: K1's inputs, random flags, past
    actions and (if ``wall``) a random wall mask."""
    pos, radius, valid = _inputs(seed, E, A, dtype, device, nan)
    rng = np.random.RandomState(seed + 1)
    at_goal = rng.rand(E, A) < 0.2
    in_coll = rng.rand(E, A) < 0.15
    # is_at_goal, was_at_goal_already, was_in_collision_already, in_collision
    flags = [at_goal, at_goal & (rng.rand(E, A) < 0.5),
             in_coll & (rng.rand(E, A) < 0.5), in_coll]
    flags = [torch.tensor(f, device=device) for f in flags]
    past = torch.tensor(rng.uniform(-1, 1, (E, A, 3, 2)), dtype=dtype, device=device)
    mask = torch.tensor(rng.rand(E, A) < 0.1, device=device) if wall else None
    return (pos, radius, valid, *flags, past, mask, REWARD_CFG)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
            continue
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        itype = torch.int32 if g.dtype == torch.float32 else torch.int64
        assert torch.equal(g[ok].view(itype), w[ok].view(itype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,E,A,nan,wall,lanes", [
    (torch.float32, 16384, 4, False, False, 0),
    (torch.float32, 256, 20, False, True, 0),
    (torch.float32, 512, 40, False, False, 0),
    (torch.float32, 64, 2, False, True, 0),
    (torch.float32, 64, 4, True, True, 0),
    (torch.float64, 64, 2, False, False, 0),
    (torch.float64, 64, 4, True, False, 0),
    (torch.float64, 256, 20, False, False, 0),
    (torch.float64, 512, 40, False, True, 0),
    (torch.float32, 16384, 4, False, False, 1),
    (torch.float32, 512, 40, False, True, 1),
    (torch.float64, 256, 20, True, False, 2),
    (torch.float32, 255, 3, False, True, 32),
])
def test_cuda_reward_kernel_bitwise_equals_plain(cuda_device, dtype, E, A, nan, wall, lanes):
    """Every layout (``lanes`` threads a row; 0 is the kernel's choice) gives
    the plain version's bits, in one launch."""
    args = _reward_inputs(9, E, A, dtype, cuda_device, nan, wall)
    before = ops.launch_counts()["pairwise"]
    if lanes:
        got = tpair.pairwise_rewards_cuda(*args, lanes=lanes)
        _assert_bitwise(tpair.pairwise_collisions_cuda(*args[:3], lanes=lanes),
                        tpair.pairwise_collisions_plain(*args[:3]))
        before += 1
    else:
        got = tpair.pairwise_rewards(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise"] == before + 1
    want = tpair.pairwise_rewards_plain(*args)
    _assert_bitwise(got, want)
    assert got[3] is not args[6]
    if E >= 256:
        # the inputs reach the chain's branches: goal, collision or the
        # clip's low end, getting close, a wiggly turn
        reward = want[2][args[2]]
        cfg = REWARD_CFG
        for value in (cfg.reward_at_goal, cfg.reward_collision_with_agent,
                      cfg.reward_wiggly_behavior):
            assert bool((reward == value).any()), value
        assert bool(((reward < cfg.reward_getting_close) & (reward > -0.2)).any())


@pytest.mark.cuda
def test_cuda_reward_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    args = list(_reward_inputs(6, 8, 4, torch.float32, cuda_device, False, True))

    def call(i, value):
        bad = list(args)
        bad[i] = value
        return tpair.pairwise_rewards(*bad)

    with pytest.raises(TypeError):
        call(7, args[7].double())                       # past_actions dtype
    with pytest.raises(TypeError):
        call(6, args[6].to(torch.uint8))                # in_collision dtype
    with pytest.raises(TypeError):
        tpair.pairwise_rewards(*(a.half() if torch.is_tensor(a) and a.is_floating_point()
                                 else a for a in args))
    with pytest.raises(ValueError):
        call(8, args[8][:, :3])                         # wall shape
    with pytest.raises(ValueError):
        call(7, args[7][..., 0])                        # past_actions rank
    with pytest.raises(ValueError):
        call(3, args[3].cpu())                          # device
    with pytest.raises(ValueError):                     # past_actions not contiguous
        call(7, args[7].transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError):
        tpair.pairwise_rewards_cuda(*args, lanes=3)
