"""Occupancy-grid maps over env batches (port of
:mod:`gym_collision_avoidance_tpu.maps.grid`).

The static map is a ``[H, W]`` bool grid shared by every env; the dynamic
(agent-stamped) map is ``[E, H, W]`` and is recomputed when a sensor needs
it.  Grid convention (Map.py:26-32): row index i = floor(H/2 - y/cell),
column index j = floor(W/2 + x/cell).

Every quotient by a configured constant is a product with the reciprocal
rounded to the state's dtype, :func:`reciprocal`: XLA compiles the JAX
package's ``x / cell`` to ``x * (1 / cell)``, and CUDA PyTorch would do
the same to a division by a Python scalar while CPU PyTorch divides.
Nothing here copies from the host per call, so a step can be captured in
a CUDA graph and never waits on the card.

A disc stamp is computed per grid row as the column span its cells cover
(:func:`_disc_row_spans`), so the stamps and the wall test cost
``[E, A, H]`` work instead of the ``[E, A, H, W]`` masks the JAX package
materializes; :func:`agent_disc_masks` expands the spans for callers that
want the masks.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.maths import sqrt_rn

WORLD_MAPS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "world_maps")


def world_map_path(name: str) -> str:
    """Path of one of the package's world-map PNGs, copies of the
    reference's ``envs/world_maps/{000,001,002}.png``."""
    path = os.path.join(WORLD_MAPS_DIR, name if name.endswith(".png") else name + ".png")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no world map {name!r} at {path}")
    return path


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png_grey8(path: str) -> np.ndarray:
    """Decode an 8-bit greyscale, non-interlaced PNG into ``[H, W]`` uint8
    with the standard library (zlib and the five row filters of the PNG
    specification, section 9).  Any other format raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    width, height, depth, colour, _compression, _filter, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(f"{path}: only 8-bit greyscale non-interlaced PNGs are read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width + 1):
        raise ValueError(f"{path}: image data has {len(raw)} bytes, expected "
                         f"{height * (width + 1)}")
    out = np.zeros((height, width), np.uint8)
    prev = bytearray(width)
    for r in range(height):
        ftype = raw[r * (width + 1)]
        row = bytearray(raw[r * (width + 1) + 1:(r + 1) * (width + 1)])
        if ftype == 1:      # Sub
            for i in range(1, width):
                row[i] = (row[i] + row[i - 1]) & 0xFF
        elif ftype == 2:    # Up
            for i in range(width):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ftype == 3:    # Average
            for i in range(width):
                left = row[i - 1] if i else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:    # Paeth
            for i in range(width):
                left = row[i - 1] if i else 0
                upleft = prev[i - 1] if i else 0
                row[i] = (row[i] + _paeth(left, prev[i], upleft)) & 0xFF
        elif ftype != 0:
            raise ValueError(f"{path}: unknown PNG row filter {ftype}")
        out[r] = np.frombuffer(bytes(row), np.uint8)
        prev = row
    return out


def load_static_map(cfg: EnvConfig, map_filename: str | None = None) -> np.ndarray:
    """Host-side: the ``[H, W]`` bool static map (Map.py:12-21).  None gives
    an empty map; a PNG is inverted (white = free) and nearest-resized to
    the configured size."""
    H = int(cfg.map_y_width / cfg.map_grid_cell_size)
    W = int(cfg.map_x_width / cfg.map_grid_cell_size)
    if map_filename is None:
        return np.zeros((H, W), dtype=bool)
    img = read_png_grey8(map_filename)
    if img.shape != (H, W):
        ri = (np.arange(H) * img.shape[0] / H).astype(int)
        ci = (np.arange(W) * img.shape[1] / W).astype(int)
        img = img[ri][:, ci]
    return np.invert(img.astype(bool))


def occupied_cell_list(static_map: np.ndarray, max_cells: int | None = None) -> np.ndarray:
    """Host-side: the occupied (i, j) cells of a static map as an ``[S, 2]``
    int32 array padded with -1 rows to ``max_cells`` (default: no padding)."""
    static_map = np.asarray(static_map)
    ii, jj = np.where(static_map)
    cells = np.stack([ii, jj], axis=1).astype(np.int32)
    if max_cells is None:
        max_cells = len(cells)
    if len(cells) > max_cells:
        raise ValueError(
            f"static map has {len(cells)} occupied cells > max_cells={max_cells};"
            " use the dense gather path instead"
        )
    pad = np.full((max_cells - len(cells), 2), -1, np.int32)
    return np.concatenate([cells, pad])


def reciprocal(value: float, dtype: torch.dtype) -> float:
    """``1 / value`` computed and rounded in ``dtype``, as a Python float that
    ``dtype`` holds exactly: the factor XLA multiplies by where the JAX
    package divides by the constant ``value``.  A product with a Python
    scalar is exact on both devices (only a quotient by one is rewritten
    on CUDA), and needs no host-to-device copy."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return float(np_dtype(1.0) / np_dtype(value))


def map_shape(cfg: EnvConfig):
    return (int(cfg.map_y_width / cfg.map_grid_cell_size),
            int(cfg.map_x_width / cfg.map_grid_cell_size))


def map_origin(cfg: EnvConfig):
    """``(oi, oj)``: the cell coordinates of the world origin."""
    cell = cfg.map_grid_cell_size
    return (cfg.map_y_width / 2.0) / cell, (cfg.map_x_width / 2.0) / cell


def world_to_map(pos, cfg: EnvConfig, shape):
    """``[..., 2]`` world coordinates -> (i, j, in_map) (Map.py:26-44)."""
    H, W = shape
    oi, oj = map_origin(cfg)
    inv_cell = reciprocal(cfg.map_grid_cell_size, pos.dtype)
    i = torch.floor(oi - pos[..., 1] * inv_cell).to(torch.int32)
    j = torch.floor(oj + pos[..., 0] * inv_cell).to(torch.int32)
    in_map = (i >= 0) & (j >= 0) & (i < H) & (j < W)
    return i, j, in_map


def radius_cells_sq(radius, cfg: EnvConfig):
    """``(radius / cell)**2``, the squared disc radius in cells."""
    r = radius * reciprocal(cfg.map_grid_cell_size, radius.dtype)
    return r * r


def _disc_row_spans(pos, radius, cfg: EnvConfig, shape):
    """Column spans of the disc stamps (Map.py:52-64), row by row.

    Cell (i, j) is in the disc of an agent at cell (gi, gj) iff
    ``(j - gj)**2 + (i - gi)**2 < r**2`` (integer square sum against the
    float squared radius in cells) and the agent's centre is on the map.
    For row i that holds for ``|j - gj| <= m`` with m the largest integer
    passing the test, found from a square root and corrected by one step
    each way, so it is exact.

    Returns (lo, hi) ``[..., H]`` int64 columns clipped to the map, with
    lo > hi for rows the disc does not touch.
    """
    H, W = shape
    gi, gj, in_map = world_to_map(pos, cfg, shape)
    rsq = radius_cells_sq(radius, cfg)[..., None]
    di = torch.arange(H, dtype=torch.int32, device=pos.device) - gi[..., None]
    di2 = di * di
    dtype = rsq.dtype

    def inside(m):
        return (m * m + di2).to(dtype) < rsq

    m = torch.floor(sqrt_rn(torch.clamp(rsq - di2.to(dtype), min=0.0))).to(torch.int32)
    m = torch.where(inside(m), m, m - 1)
    m = torch.where(inside(m + 1), m + 1, m)
    touched = inside(torch.zeros_like(m)) & in_map[..., None]
    lo = torch.clamp(gj[..., None] - m, min=0).to(torch.int64)
    hi = torch.clamp(gj[..., None] + m, max=W - 1).to(torch.int64)
    lo = torch.where(touched, lo, torch.full_like(lo, W))
    hi = torch.where(touched, hi, torch.full_like(hi, -1))
    return lo, hi


def agent_disc_masks(pos, radius, cfg: EnvConfig, shape):
    """``[..., A, H, W]`` bool disc stamps; all False for an agent whose
    centre is off the map."""
    lo, hi = _disc_row_spans(pos, radius, cfg, shape)
    cols = torch.arange(shape[1], device=pos.device)
    return (cols >= lo[..., None]) & (cols <= hi[..., None])


def stamp_agents(static_map, pos, radius, valid, cfg: EnvConfig):
    """Static map + the discs of the valid agents -> ``[E, H, W]`` dynamic
    map (Map.py:46-50)."""
    H, W = static_map.shape
    E = pos.shape[0]
    lo, hi = _disc_row_spans(pos, radius, cfg, (H, W))            # [E, A, H]
    use = (lo <= hi) & valid[..., None]
    one = use.to(torch.int32).permute(0, 2, 1)                    # [E, H, A]
    # +1 at each span's first column, -1 after its last, summed along rows
    diff = torch.zeros((E, H, W + 1), dtype=torch.int32, device=pos.device)
    diff.scatter_add_(2, torch.where(use, lo, 0).permute(0, 2, 1), one)
    diff.scatter_add_(2, torch.where(use, hi + 1, 0).permute(0, 2, 1), -one)
    covered = torch.cumsum(diff, dim=2)[..., :W] > 0
    return static_map.to(pos.device)[None] | covered


def wall_collisions(static_map, pos, radius, valid, cfg: EnvConfig):
    """``[E, A]`` bool: a static occupied cell lies inside the agent's disc
    (only for valid agents whose centre is on the map;
    collision_avoidance_env.py:494-506).  Row prefix sums of the static map
    count the occupied cells of each disc row span."""
    H, W = static_map.shape
    occ = static_map.to(device=pos.device, dtype=torch.int32)
    prefix = torch.zeros((H, W + 1), dtype=torch.int32, device=pos.device)
    prefix[:, 1:] = torch.cumsum(occ, dim=1)
    lo, hi = _disc_row_spans(pos, radius, cfg, (H, W))            # [..., A, H]
    rows = torch.arange(H, device=pos.device)
    hit = prefix[rows, torch.clamp(hi + 1, 0, W)] - prefix[rows, torch.clamp(lo, 0, W)]
    return torch.any((lo <= hi) & (hit > 0), dim=-1) & valid
