"""K2, the full-range laserscan ray march, for Hopper.

Port of the Pallas TPU kernel ``gym_collision_avoidance_tpu/ops/raymarch.py``
(``_make_kernel``, launched by ``laserscan_sparse_pallas``), whose XLA twin
is the full pass of ``obs/sensors.py:laserscan_sparse``.  For every host
agent and beam it marches the R = 60 range samples
``p = pos + r * (cos, sin)``, maps each to its cell
``(i, j) = (floor(oi - y / cell), floor(oj + x / cell))`` and finds the
reference's range (LaserScanSensor.py:63-82): with k1, k2 the first two
sample indices that hit, the range is ``r[k2 - 1]``, ``r[R - 1]`` with a
single hit, or the maximum range with none.  A sample hits when it lies on
the map, outside the host's own disc, and inside another agent's disc
(``di**2 + dj**2 < (radius / cell)**2`` on the cell deltas) or on a static
occupied cell.

Three pieces:

* :func:`march_plain` -- the plain PyTorch version, over any per-host
  source set (the wedge-culled route of ``laserscan_sparse`` uses it too);
* the hand-written CUDA kernel ``csrc/raymarch.cu``, bitwise equal to the
  plain version on the card (see the note at its top).  It does not test
  every sample against every source: each warp drops the sources that miss
  the wedge of its 32 beams, each remaining source (disc or static cell)
  gets a conservative band of samples from the beam's distance to its cell
  centre, and the exact test runs only inside the bands, up to the second
  hit (``tests/test_torch_raymarch_band.py`` models it on the CPU);
* :func:`raymarch` -- the wrapper ``laserscan_sparse`` calls on its full
  pass.  A CPU tensor goes to the plain version; a CUDA tensor goes to
  the kernel, or the wrapper raises.

The beams' cosines and sines are inputs, computed once by PyTorch, so the
kernel and the plain version read the same bits.  Disc tables carry the
row sentinel 40000 for agents that are invalid or off the map, which no
sample reaches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gym_collision_avoidance_torch.maps import grid as map_grid
from gym_collision_avoidance_torch.ops import build

LASER_RANGE_RESOLUTION = 0.1
LASER_MAX_RANGE = 6.0
# len(np.arange(0, max_range, resolution)), LaserScanSensor.py:32-39
LASER_NUM_RANGE_SAMPLES = len(np.arange(0.0, LASER_MAX_RANGE, LASER_RANGE_RESOLUTION))

KERNEL = build.Kernel("raymarch", "raymarch", [ctypes.c_void_p] * 12 + [ctypes.c_int64]
                      + [ctypes.c_int] * 6 + [ctypes.c_double] * 4)


def range_samples(dtype, device) -> torch.Tensor:
    """The range-sample table ``k * resolution`` in ``dtype``, the JAX
    package's ``_range_samples`` (bitwise equal to the reference's
    ``np.arange(0, 6, 0.1)`` in float64)."""
    k = torch.arange(LASER_NUM_RANGE_SAMPLES, device=device).to(dtype)
    return k * LASER_RANGE_RESOLUTION          # the scalar is cast to dtype first


def _map_consts(cfg):
    return map_grid.map_shape(cfg) + map_grid.map_origin(cfg)


def march_plain(pos_e, cos_b, sin_b, gi_e, gj_e, rsq_e, gi_d, gj_d, rsq_d,
                static_cells, cfg):
    """Ranges ``[E, Ae, Lb]`` in plain PyTorch.

    Args:
        pos_e: ``[E, Ae, 2]`` host positions; cos_b, sin_b: ``[E, Ae, Lb]``.
        gi_e, gj_e, rsq_e: ``[E, Ae]`` the host's own disc (cell, squared
            radius in cells; row 40000 when it has none).
        gi_d, gj_d, rsq_d: ``[E, Ae or 1, S]`` the discs that can be hit.
        static_cells: ``[S_c, 2]`` int32 occupied cells, -1 rows padding.
    """
    H, W, oi, oj = _map_consts(cfg)
    dtype, device = pos_e.dtype, pos_e.device
    R = LASER_NUM_RANGE_SAMPLES
    rsamples = range_samples(dtype, device)
    inv_cell = map_grid.reciprocal(cfg.map_grid_cell_size, dtype)
    cells = static_cells.to(device=device, dtype=torch.int32)
    x0, y0 = pos_e[..., 0, None], pos_e[..., 1, None]
    k1 = torch.full(cos_b.shape, R, dtype=torch.int32, device=device)
    k2 = k1.clone()
    for k in range(R):
        px = x0 + rsamples[k] * cos_b
        py = y0 + rsamples[k] * sin_b
        ii = torch.floor(oi - py * inv_cell).to(torch.int32)
        jj = torch.floor(oj + px * inv_cell).to(torch.int32)
        in_map = (ii >= 0) & (jj >= 0) & (ii < H) & (jj < W)
        di = ii[:, :, None, :] - gi_d[..., None]
        dj = jj[:, :, None, :] - gj_d[..., None]
        hit = torch.any((di * di + dj * dj).to(dtype) < rsq_d[..., None], dim=2)
        if cells.shape[0] > 0:
            hit = hit | torch.any((ii[:, :, None, :] == cells[:, 0, None])
                                  & (jj[:, :, None, :] == cells[:, 1, None]), dim=2)
        dei = ii - gi_e[..., None]
        dej = jj - gj_e[..., None]
        in_ego = (dei * dei + dej * dej).to(dtype) < rsq_e[..., None]
        hit = hit & ~in_ego & in_map
        k2 = torch.where(hit & (k1 < R) & (k2 == R), k, k2)
        k1 = torch.where(hit & (k1 == R), k, k1)
    ans = torch.where(k1 == R, -1, torch.where(k2 == R, R - 1, k2 - 1))
    return torch.where(ans >= 0, rsamples[ans.clamp(min=0).long()],
                       torch.full_like(cos_b, LASER_MAX_RANGE))


def raymarch_plain(pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq, static_cells, cfg):
    """The plain version of K2: :func:`march_plain` against every disc of
    the env (``gi, gj, rsq`` ``[E, A]``)."""
    return march_plain(pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e,
                       gi[:, None, :], gj[:, None, :], rsq[:, None, :], static_cells, cfg)


def raymarch_cuda(pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq, static_cells, cfg):
    """Launch the CUDA kernel on the current stream (no synchronise)."""
    dtype = pos_e.dtype
    KERNEL.check(dtype)
    if pos_e.dim() != 3 or pos_e.shape[-1] != 2:
        raise ValueError(f"pos_e must be [E, Ae, 2], got {tuple(pos_e.shape)}")
    E, Ae = pos_e.shape[:2]
    L = cos_a.shape[-1]
    A = gi.shape[-1]
    i32 = torch.int32
    build.check_launch_args(
        [("pos_e", pos_e, dtype, (E, Ae, 2)), ("cos_a", cos_a, dtype, (E, Ae, L)),
         ("sin_a", sin_a, dtype, (E, Ae, L)), ("gi_e", gi_e, i32, (E, Ae)),
         ("gj_e", gj_e, i32, (E, Ae)), ("rsq_e", rsq_e, dtype, (E, Ae)),
         ("gi", gi, i32, (E, A)), ("gj", gj, i32, (E, A)), ("rsq", rsq, dtype, (E, A)),
         ("static_cells", static_cells, i32, (static_cells.shape[0], 2))],
        pos_e.device)
    H, W, oi, oj = _map_consts(cfg)
    rsamples = range_samples(dtype, pos_e.device)
    inv_cell = map_grid.reciprocal(cfg.map_grid_cell_size, dtype)
    out = torch.empty((E, Ae, L), dtype=dtype, device=pos_e.device)
    KERNEL(
        dtype, pos_e.data_ptr(), cos_a.data_ptr(), sin_a.data_ptr(), gi_e.data_ptr(),
        gj_e.data_ptr(), rsq_e.data_ptr(), gi.data_ptr(), gj.data_ptr(), rsq.data_ptr(),
        static_cells.data_ptr(), rsamples.data_ptr(), out.data_ptr(),
        E, Ae, A, L, static_cells.shape[0], H, W, oi, oj, inv_cell,
        cfg.map_grid_cell_size / LASER_RANGE_RESOLUTION,    # range samples per cell
        device=pos_e.device,
    )
    return out


def raymarch(pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq, static_cells, cfg):
    """Full-pass laserscan ranges ``[E, Ae, L]``: CPU tensors -> plain
    version; CUDA tensors -> the CUDA kernel."""
    if pos_e.device.type == "cpu":
        return raymarch_plain(pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq,
                              static_cells, cfg)
    if pos_e.device.type == "cuda":
        return raymarch_cuda(pos_e, cos_a, sin_a, gi_e, gj_e, rsq_e, gi, gj, rsq,
                             static_cells, cfg)
    raise ValueError(f"no raymarch for device {pos_e.device}")
