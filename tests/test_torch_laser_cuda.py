"""K2's and K3's CUDA kernels against their plain PyTorch versions, on the
card.

Imports neither JAX nor ``tests/conftest.py``'s setup, so it runs on a
machine with a CUDA card and no JAX::

    python -m pytest --noconftest -q tests/test_torch_laser_cuda.py

Without a card every case skips.  The kernels' inputs are captured from
``laserscan_sparse`` on the card, so they are exactly what the sensor
hands them; ranges and overflow flags must be bitwise equal (the kernels
do the plain versions' IEEE operations in the same order, without FMA
contraction; see ``csrc/raymarch.cu`` and ``csrc/laser_fused.cu``).
"""

import contextlib

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig, init_state, ops
from gym_collision_avoidance_torch.maps import grid as tgrid
from gym_collision_avoidance_torch.obs import sensors as tsens
from gym_collision_avoidance_torch.ops import laser_fused, raymarch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def capture(module, name, calls):
    """Record the arguments of every call of ``module.name``."""
    orig = getattr(module, name)

    def spy(*args):
        calls.append(args)
        return orig(*args)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _setup(dtype, device, seed, E=3, A=7, with_map=True, **route):
    cfg = EnvConfig(dtype=dtype, use_static_map=True, map_x_width=10.0, map_y_width=10.0,
                    laserscan_length=128, **route)
    static = tgrid.load_static_map(cfg, tgrid.world_map_path("002") if with_map else None)
    cells = tgrid.occupied_cell_list(static, int(static.sum()) + 3)
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-3.0, 3.0, (E, A, 2))
    pos[0, 0] = [5.5, 0.0]                     # off the map
    state = init_state(cfg, pos, rng.uniform(-4, 4, (E, A, 2)), rng.uniform(0.2, 0.3, (E, A)),
                       np.ones((E, A)), heading=rng.uniform(-np.pi, np.pi, (E, A)),
                       valid=rng.rand(E, A) > 0.15, device=device)
    return cfg, state, torch.as_tensor(cells, device=device)


def _bitwise(a, b):
    itype = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(itype), b.view(itype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("with_map", [False, True])
@pytest.mark.parametrize("ego_idx", [None, (1, 4)])
def test_k2_bitwise_equals_plain(cuda_device, dtype, with_map, ego_idx):
    cfg, state, cells = _setup(dtype, cuda_device, 1, with_map=with_map)
    calls = []
    before = ops.launch_counts()["raymarch"]
    with capture(raymarch, "raymarch_cuda", calls):
        out = tsens.laserscan_sparse(state, cfg, cells, ego_idx=ego_idx)
    torch.cuda.synchronize()
    assert ops.launch_counts()["raymarch"] == before + 1 and len(calls) == 1
    ref = raymarch.raymarch_plain(*calls[0])
    assert _bitwise(out, ref)
    assert (ref < 6.0).sum() > 50


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("route", [
    dict(laserscan_entry_window=12, laserscan_beam_slots=4),
    dict(laserscan_entry_window=12, laserscan_beam_slots=1),
    dict(laserscan_num_candidate_discs=4, laserscan_entry_window=12, laserscan_beam_slots=4),
])
def test_k3_bitwise_equals_plain(cuda_device, dtype, route):
    cfg, state, cells = _setup(dtype, cuda_device, 2, **route)
    calls = []
    before = ops.launch_counts()["laser_fused"]
    with capture(laser_fused, "beam_compacted_cuda", calls):
        tsens.laserscan_sparse(state, cfg, cells, return_overflow=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["laser_fused"] == before + 1 and len(calls) == 1
    out, ovf = laser_fused.beam_compacted_cuda(*calls[0])
    ref, ref_ovf = laser_fused.beam_compacted_plain(*calls[0])
    torch.cuda.synchronize()
    assert _bitwise(out, ref)
    assert torch.equal(ovf, ref_ovf)
    if route["laserscan_beam_slots"] == 1:
        assert ref_ovf.any()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    cfg, state, cells = _setup("float32", cuda_device, 3, laserscan_entry_window=12,
                               laserscan_beam_slots=4)
    calls = []
    with capture(laser_fused, "beam_compacted_cuda", calls):
        tsens.laserscan_sparse(state, cfg, cells)
    args = list(calls[0])
    with pytest.raises(ValueError, match="slots"):
        laser_fused.beam_compacted_cuda(*args[:-1], 0)
    bad = list(args)
    bad[6] = args[6].to(torch.int64)
    with pytest.raises(TypeError):
        laser_fused.beam_compacted_cuda(*bad)
    calls = []
    with capture(raymarch, "raymarch_cuda", calls):
        tsens.laserscan_sparse(state, cfg.replace(laserscan_entry_window=None,
                                                  laserscan_beam_slots=None), cells)
    args = list(calls[0])
    bad = list(args)
    bad[1] = args[1][:, :, :64]
    with pytest.raises(ValueError):
        raymarch.raymarch_cuda(*bad)
    bad = list(args)
    bad[0] = args[0].cpu()
    with pytest.raises(ValueError):
        raymarch.raymarch_cuda(*bad)
