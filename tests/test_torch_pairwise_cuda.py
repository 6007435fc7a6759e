"""K1's CUDA kernel against its plain PyTorch version, on the card.

Imports neither JAX nor ``tests/conftest.py``'s setup, so it runs on a
machine with a CUDA card and no JAX::

    python -m pytest --noconftest -q tests/test_torch_pairwise_cuda.py

Without a card every case skips.  Collision flags are equal and nearest
gaps bitwise equal: the kernel does the plain version's IEEE operations in
the same order, without FMA contraction (see ``csrc/pairwise.cu``).
"""

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch.ops import pairwise as tpair


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
    before = tpair.LAUNCHES
    coll, near = tpair.pairwise_collisions(*args)
    torch.cuda.synchronize()
    assert tpair.LAUNCHES == before + 1
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
