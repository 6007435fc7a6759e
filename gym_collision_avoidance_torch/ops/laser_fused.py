"""K3, the fused windowed, beam-compacted laserscan pass, for Hopper.

Port of the Pallas TPU kernel ``gym_collision_avoidance_tpu/ops/laser_pallas.py``
(``_make_kernel``, launched by ``windowed_beam_compacted_pallas``), whose
XLA twin is ``obs/sensors.py:_windowed_beam_compacted``.  For every host
agent and beam, in three stages:

1. screen each source (another agent's disc, or a static occupied cell)
   by its slack-inflated analytic band along the beam (``t_c``, ``disc``,
   ``t_lo``/``t_hi``) and the window start ``k0 = floor(t_lo / res) - 1``;
2. keep the first ``Cs`` band-crossing sources in source order (stable
   first-come compaction) and flag the beam when a further one crosses;
3. test the exact cell predicate on ``Wn`` samples from each kept source's
   ``k0`` and merge the two smallest distinct hit indices into the range,
   as the full pass's first-hit rule does.

The kernel keeps the Pallas kernel's two deliberate deviations from the
XLA twin (laser_pallas.py:19-23): the slot overflow is the direct
condition (some beam sees a ``Cs + 1``-th source), and the integer disc
radius is not clamped to 63 (the XLA twin packs it in 6 bits and flags
radii above 0.79 m on a 0.1 m grid).  With every radius at or below that,
the two agree exactly, ranges and flag.

Sources come per host and per beam block: ``[E, Ae, B, S]`` fields, where
the beams split into B equal blocks (B = L / 128 on the wedge-culled
route, whose candidates differ per block, else B = 1).  The per-source
scalars without a beam axis (``relx``, ``rely``, ``rel2 = relx**2 +
rely**2``, ``ro2 = r_out**2``, the integer radius ``irsq``) are computed
by the caller in PyTorch, as the Pallas wrapper computes them in jnp; so
is the window-span guard, which has no beam axis.

Three pieces: :func:`beam_compacted_plain` (plain PyTorch), the CUDA kernel
``csrc/laser_fused.cu`` (bitwise equal to it on the card), and the wrapper
:func:`beam_compacted`: CPU tensors -> plain version, CUDA tensors -> the
kernel or an error.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gym_collision_avoidance_torch.core.maths import sqrt_rn
from gym_collision_avoidance_torch.maps import grid as map_grid
from gym_collision_avoidance_torch.ops import build
from gym_collision_avoidance_torch.ops.raymarch import (
    LASER_MAX_RANGE,
    LASER_NUM_RANGE_SAMPLES,
    LASER_RANGE_RESOLUTION,
)

KERNEL = build.Kernel("laser_fused", "laser_fused", [ctypes.c_void_p] * 16 + [ctypes.c_int64]
                      + [ctypes.c_int] * 7 + [ctypes.c_double] * 6)


def consts(cfg, dtype):
    """``(H, W, oi, oj, inv_cell, res, inv_res, t_max)``: the grid and range
    constants as Python floats that ``dtype`` holds exactly."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    res = np_dtype(LASER_RANGE_RESOLUTION)
    return (*map_grid.map_shape(cfg), *map_grid.map_origin(cfg),
            map_grid.reciprocal(cfg.map_grid_cell_size, dtype), float(res),
            map_grid.reciprocal(LASER_RANGE_RESOLUTION, dtype),
            float(np_dtype(LASER_NUM_RANGE_SAMPLES - 1) * res))


def ranges_from_hits(idx, dtype):
    """Ranges from hit indices ``[..., n, Lb]`` (R = no hit) by the first-hit
    rule: with m1 < m2 the two smallest distinct indices over n, the range
    is ``(m2 - 1) * res``, ``(R - 1) * res`` for a single hit, or the
    maximum range -> ``[..., Lb]``."""
    R = LASER_NUM_RANGE_SAMPLES
    m1 = idx.amin(dim=-2)
    m2 = torch.where(idx > m1[..., None, :], idx, R).amin(dim=-2)
    ans = torch.where(m1 >= R, -1, torch.where(m2 >= R, R - 1, m2 - 1))
    return torch.where(ans >= 0, ans.to(dtype) * LASER_RANGE_RESOLUTION,
                       torch.full(ans.shape, LASER_MAX_RANGE, dtype=dtype, device=idx.device))


def beam_compacted_plain(pos_e, gi_e, gj_e, rsq_e, cos_a, sin_a, gi_d, gj_d, irsq_d,
                         relx, rely, rel2, ro2, span_ok, cfg, Wn, Cs):
    """(ranges ``[E, Ae, L]``, slot overflow ``[E, Ae, L]`` bool) in plain
    PyTorch.

    Args:
        pos_e: ``[E, Ae, 2]``; gi_e, gj_e (int32), rsq_e: ``[E, Ae]`` the
            host's own disc; cos_a, sin_a: ``[E, Ae, L]``.
        gi_d, gj_d, irsq_d (int32), relx, rely, rel2, ro2, span_ok (bool):
            ``[E, Ae, B, S]`` source fields of each beam block.
    """
    H, W, oi, oj, inv_cell, res, inv_res, t_max = consts(cfg, pos_e.dtype)
    R = LASER_NUM_RANGE_SAMPLES
    dtype, device = pos_e.dtype, pos_e.device
    E, Ae, L = cos_a.shape
    B, S = gi_d.shape[2:]
    Lb = L // B
    c = cos_a.reshape(E, Ae, B, 1, Lb)
    s = sin_a.reshape(E, Ae, B, 1, Lb)

    # ---- screen: [E, Ae, B, S, Lb] ----
    t_c = relx[..., None] * c + rely[..., None] * s
    bb = rel2[..., None] - t_c * t_c
    disc = ro2[..., None] - bb
    half_o = sqrt_rn(torch.clamp(disc, min=0.0))
    t_lo = t_c - half_o
    t_hi = t_c + half_o
    rel = (disc > 0.0) & (t_hi >= 0.0) & (t_lo <= t_max) & span_ok[..., None]
    k0 = torch.clamp(torch.floor(t_lo * inv_res).to(torch.int32) - 1, 0, R)

    # ---- stable first-come compaction into n slots ----
    count = rel.sum(dim=3)                                        # [E, Ae, B, Lb]
    overflow = count > Cs
    n = min(Cs, S)
    order = torch.argsort((~rel).to(torch.uint8), dim=3, stable=True)[:, :, :, :n]
    filled = torch.arange(n, device=device)[:, None] < count[:, :, :, None, :]

    def take(v):                                                  # -> [E, Ae, B, n, Lb]
        if v.dim() == 4:
            v = v[..., None].expand(E, Ae, B, S, Lb)
        return torch.gather(v, 3, order)

    k0_c, gi_c, gj_c, irsq_c = take(k0), take(gi_d), take(gj_d), take(irsq_d)

    # ---- window pass and the two smallest distinct hit indices ----
    x0 = pos_e[..., 0][:, :, None, None, None]
    y0 = pos_e[..., 1][:, :, None, None, None]
    gie = gi_e[:, :, None, None, None]
    gje = gj_e[:, :, None, None, None]
    rsqe = rsq_e[:, :, None, None, None]
    idx = []
    for w in range(Wn):
        k = k0_c + w
        rr = k.to(dtype) * res
        px = x0 + rr * c
        py = y0 + rr * s
        ii = torch.floor(oi - py * inv_cell).to(torch.int32)
        jj = torch.floor(oj + px * inv_cell).to(torch.int32)
        in_map = (ii >= 0) & (ii < H) & (jj >= 0) & (jj < W)
        di, dj = ii - gi_c, jj - gj_c
        in_src = di * di + dj * dj < irsq_c
        dei, dej = ii - gie, jj - gje
        in_ego = (dei * dei + dej * dej).to(dtype) < rsqe
        # a sample at k >= R does not exist; the XLA twin lets it through
        # as an index >= R, which its first-hit rule reads as a miss
        hit = filled & in_src & ~in_ego & in_map & (k < R)
        idx.append(torch.where(hit, k, R))
    idx = torch.stack(idx, dim=3).flatten(3, 4)                   # [E, Ae, B, n*Wn, Lb]
    if idx.shape[3] == 0:                                         # no source at all
        idx = torch.full((E, Ae, B, 1, Lb), R, dtype=torch.int32, device=device)
    val = ranges_from_hits(idx, dtype)
    return val.reshape(E, Ae, L), overflow.reshape(E, Ae, L)


def beam_compacted_cuda(pos_e, gi_e, gj_e, rsq_e, cos_a, sin_a, gi_d, gj_d, irsq_d,
                        relx, rely, rel2, ro2, span_ok, cfg, Wn, Cs):
    """Launch the CUDA kernel on the current stream (no synchronise).

    The kernel's per-warp wedge pre-screen takes each block's beams in the
    sensor's order: angles rising by less than pi over 32 beams, as
    ``obs/sensors.py:beam_angles`` plus a heading gives them."""
    dtype = pos_e.dtype
    KERNEL.check(dtype)
    if pos_e.dim() != 3 or pos_e.shape[-1] != 2:
        raise ValueError(f"pos_e must be [E, Ae, 2], got {tuple(pos_e.shape)}")
    if Cs < 1:
        raise ValueError(f"the kernel needs Cs >= 1 slots a beam, got {Cs}")
    E, Ae = pos_e.shape[:2]
    L = cos_a.shape[-1]
    if gi_d.dim() != 4:
        raise ValueError(f"source fields must be [E, Ae, B, S], got {tuple(gi_d.shape)}")
    B, S = gi_d.shape[2:]
    if B < 1 or L % B:
        raise ValueError(f"{L} beams do not split into {B} blocks")
    i32 = torch.int32
    fields = [("pos_e", pos_e, dtype, (E, Ae, 2)), ("gi_e", gi_e, i32, (E, Ae)),
              ("gj_e", gj_e, i32, (E, Ae)), ("rsq_e", rsq_e, dtype, (E, Ae)),
              ("cos_a", cos_a, dtype, (E, Ae, L)), ("sin_a", sin_a, dtype, (E, Ae, L)),
              ("gi_d", gi_d, i32, (E, Ae, B, S)), ("gj_d", gj_d, i32, (E, Ae, B, S)),
              ("irsq_d", irsq_d, i32, (E, Ae, B, S)), ("relx", relx, dtype, (E, Ae, B, S)),
              ("rely", rely, dtype, (E, Ae, B, S)), ("rel2", rel2, dtype, (E, Ae, B, S)),
              ("ro2", ro2, dtype, (E, Ae, B, S)),
              ("span_ok", span_ok, torch.bool, (E, Ae, B, S))]
    device = pos_e.device
    build.check_launch_args(fields, device)
    H, W, oi, oj, inv_cell, res, inv_res, t_max = consts(cfg, dtype)
    out = torch.empty((E, Ae, L), dtype=dtype, device=device)
    ovf = torch.empty((E, Ae, L), dtype=torch.bool, device=device)
    KERNEL(dtype, *(t.data_ptr() for _, t, _, _ in fields), out.data_ptr(), ovf.data_ptr(),
           E * Ae, L, B, S, Cs, Wn, H, W, oi, oj, inv_cell, res, inv_res, t_max, device=device)
    return out, ovf


def beam_compacted(pos_e, gi_e, gj_e, rsq_e, cos_a, sin_a, gi_d, gj_d, irsq_d,
                   relx, rely, rel2, ro2, span_ok, cfg, Wn, Cs):
    """(ranges, slot overflow) ``[E, Ae, L]``: CPU tensors -> plain version;
    CUDA tensors -> the CUDA kernel."""
    args = (pos_e, gi_e, gj_e, rsq_e, cos_a, sin_a, gi_d, gj_d, irsq_d,
            relx, rely, rel2, ro2, span_ok, cfg, Wn, Cs)
    if pos_e.device.type == "cpu":
        return beam_compacted_plain(*args)
    if pos_e.device.type == "cuda":
        return beam_compacted_cuda(*args)
    raise ValueError(f"no beam_compacted for device {pos_e.device}")
