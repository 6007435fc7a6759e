"""The port's static maps (``maps/grid.py``) against the JAX package's:
the standard-library PNG decoder, the package's own map copies, and the
grid transforms, disc stamps, wall collisions and cell lists over
``[E, A]`` batches.  Every output here is discrete and must be equal."""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch.maps import grid as tgrid
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu.maps import grid as jgrid

MAPS = ("000", "001", "002")


def _cfgs(dtype, width):
    kw = dict(dtype=dtype, use_static_map=True, map_x_width=width, map_y_width=width)
    return JCfg(**kw), TCfg(**kw)


@pytest.mark.parametrize("name", MAPS)
def test_map_copies_are_byte_equal_to_the_jax_packages(name):
    with open(tgrid.world_map_path(name), "rb") as f:
        ours = f.read()
    with open(jgrid.world_map_path(name), "rb") as f:
        theirs = f.read()
    assert ours == theirs
    assert os.path.dirname(tgrid.world_map_path(name)).startswith(
        os.path.dirname(os.path.abspath(tgrid.__file__)))


@pytest.mark.parametrize("name", MAPS)
def test_png_decoder_equals_imageio(name):
    imageio = pytest.importorskip("imageio.v2")
    img = tgrid.read_png_grey8(tgrid.world_map_path(name))
    ref = imageio.imread(tgrid.world_map_path(name))
    assert img.dtype == ref.dtype and img.shape == ref.shape
    np.testing.assert_array_equal(img, ref)


def _png(width, height, depth, colour, rows, filters):
    """A PNG file in memory: ``rows`` of raw bytes, each with its filter."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    raw = b"".join(bytes([f]) + bytes(r) for f, r in zip(filters, rows))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_decoder_undoes_all_five_row_filters(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (5, 7)).astype(np.int64)
    rows = []
    for f in range(5):                      # row r uses filter r
        cur, prev = img[f], img[f - 1] if f else np.zeros(7, np.int64)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            pred = [tgrid._paeth(a, b, c) for a, b, c in zip(left, prev, upleft)]
            enc = cur - np.asarray(pred)
        rows.append((enc % 256).astype(np.uint8))
    path = tmp_path / "filters.png"
    path.write_bytes(_png(7, 5, 8, 0, rows, range(5)))
    np.testing.assert_array_equal(tgrid.read_png_grey8(str(path)), img.astype(np.uint8))
    imageio = pytest.importorskip("imageio.v2")
    np.testing.assert_array_equal(imageio.imread(str(path)), img.astype(np.uint8))


def test_png_decoder_refuses_other_formats(tmp_path):
    path = tmp_path / "rgb.png"
    path.write_bytes(_png(2, 1, 8, 2, [bytes(6)], [0]))
    with pytest.raises(ValueError, match="greyscale"):
        tgrid.read_png_grey8(str(path))
    path.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tgrid.read_png_grey8(str(path))
    with pytest.raises(FileNotFoundError):
        tgrid.world_map_path("003")


@pytest.mark.parametrize("width", [10.0, 16.0, 20.0])
@pytest.mark.parametrize("name", (None,) + MAPS)
def test_load_static_map_and_cell_list_match_jax(name, width):
    jcfg, tcfg = _cfgs("float64", width)
    ref = jgrid.load_static_map(jcfg, None if name is None else jgrid.world_map_path(name))
    got = tgrid.load_static_map(tcfg, None if name is None else tgrid.world_map_path(name))
    assert got.dtype == ref.dtype == bool
    np.testing.assert_array_equal(got, ref)
    n = int(ref.sum())
    for max_cells in (None, n + 5):
        np.testing.assert_array_equal(tgrid.occupied_cell_list(got, max_cells),
                                      jgrid.occupied_cell_list(ref, max_cells))
    if n:
        with pytest.raises(ValueError, match="max_cells"):
            tgrid.occupied_cell_list(got, n - 1)


def _agents(dtype, seed, E=4, A=9, width=10.0):
    """Agents around the 002 obstacle, some on it, some off the map."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1.6, 1.6, (E, A, 2))
    pos[:, 0] = rng.uniform(-width / 2 - 1.0, width / 2 + 1.0, (E, 2))
    pos[0, 0] = [width / 2 + 0.5, 0.0]       # off the map
    pos[0, 1] = [width / 2 - 0.05, 0.0]      # on its edge
    radius = rng.uniform(0.05, 1.3, (E, A))
    valid = rng.rand(E, A) > 0.2
    return pos.astype(dtype), radius.astype(dtype), valid


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("width", [10.0, 20.0])
def test_grid_ops_match_jax(dtype, width):
    jcfg, tcfg = _cfgs(dtype, width)
    static = jgrid.load_static_map(jcfg, jgrid.world_map_path("002"))
    shape = static.shape
    pos, radius, valid = _agents(dtype, seed=int(width), width=width)
    tpos, trad, tval = torch.tensor(pos), torch.tensor(radius), torch.tensor(valid)

    ref = jax.jit(jax.vmap(lambda p: jgrid.world_to_map(p, jcfg, shape)))(pos)
    got = tgrid.world_to_map(tpos, tcfg, shape)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    run = jax.jit(jax.vmap(lambda p, r, v: (
        jgrid.agent_disc_masks(p, r, jcfg, shape),
        jgrid.stamp_agents(jnp.asarray(static), p, r, v, jcfg),
        jgrid.wall_collisions(jnp.asarray(static), p, r, v, jcfg))))
    masks, stamped, walls = (np.asarray(x) for x in run(pos, radius, valid))
    np.testing.assert_array_equal(tgrid.agent_disc_masks(tpos, trad, tcfg, shape).numpy(), masks)
    np.testing.assert_array_equal(
        tgrid.stamp_agents(torch.tensor(static), tpos, trad, tval, tcfg).numpy(), stamped)
    np.testing.assert_array_equal(
        tgrid.wall_collisions(torch.tensor(static), tpos, trad, tval, tcfg).numpy(), walls)
    # the batch holds what the stamps decide: walls hit and missed, discs
    # clipped at the map's edge, agents off the map
    assert walls.any() and not walls.all()
    assert masks[0, 1].any() and not masks[0, 0].any()
