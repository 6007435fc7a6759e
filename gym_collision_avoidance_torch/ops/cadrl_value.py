"""SA-CADRL's value net in one launch of a hand-written CUDA kernel.

``csrc/cadrl_value.cu`` (``cadrl_value_gemm_kernel``) computes the whole of
``models/cadrl.py:forward_raw_plain`` (standardise, the four products with
their biases and ReLUs, the block max and the output's scale and offset) for
``[R, 31]`` rows, keeping every intermediate in registers and shared memory.
It replaces no Pallas kernel: the JAX package leaves this net to XLA (see
the note at the top of the source for why it was added and what bounds it).

* :func:`pack`: the weights in the layout the kernel reads; :func:`packed`
  keeps a net's packed copy and packs it again whenever one of its source
  tensors has been replaced or written in place since;
* :func:`value_net_cuda`: one launch on the current stream.  It raises on a
  net of other widths, an input of another dtype than the net's or not
  contiguous, and on a launch error; it allocates only its output.

``models/cadrl.py:forward_raw`` sends a CUDA tensor here and a CPU tensor to
the plain version.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from gym_collision_avoidance_torch.ops import build

# (in, out) of W0, W1, W3, W4: 31 -> 200 -> 200 -> block max -> 100 -> 50 -> 1
WIDTHS = {"W0": (31, 200), "W1": (200, 200), "W3": (100, 50), "W4": (50, 1)}
# The packed buffer, piece by piece in the kernel's order, each padded with
# zeros to a multiple of 4 elements.  The kernel reads W1's and W0's columns
# in groups of 25 (a thread's columns) and W3's in groups of 10, each group
# padded with zeros to 28 or 12 so that it starts on 16 bytes.
LAYOUT = (("W1", 200 * 8 * 28), ("W0", 31 * 8 * 28), ("b0", 200), ("b1", 200),
          ("W3", 100 * 5 * 12), ("b3", 52), ("W4", 52), ("b4", 4), ("avg_vec", 32),
          ("inv_std", 32), ("output_std", 4), ("output_avg", 4))
GROUPS = {"W1": (25, 28), "W0": (25, 28), "W3": (10, 12)}   # (columns, padded width)

KERNEL = build.Kernel("cadrl_value", "cadrl_value", [ctypes.c_void_p] * 3 + [ctypes.c_int64])
# net -> (fingerprint of its LAYOUT tensors, those tensors, their packed copy)
_PACKED = weakref.WeakKeyDictionary()


def pack(tensors):
    """The 1-D buffer the kernel reads, from ``{name: tensor}`` with the
    names of :data:`LAYOUT` (``W*`` as ``[in, out]``, of :data:`WIDTHS`), in
    their dtype and on their device."""
    pieces = []
    for name, size in LAYOUT:
        t = tensors[name]
        if name in GROUPS:
            cols, pad = GROUPS[name]
            t = torch.nn.functional.pad(t.reshape(t.shape[0], -1, cols), (0, pad - cols))
        t = t.reshape(-1)
        pieces.append(torch.nn.functional.pad(t, (0, size - t.numel())))
    return torch.cat(pieces)


def packed(net) -> torch.Tensor:
    """:func:`pack` of a ``CADRLValueNet``'s tensors, packed once and kept
    until one of them changes: the fingerprint is each tensor's
    ``(data_ptr(), _version)``, so replacing a tensor (``p.data = ...``,
    ``.to``, ``.double()``, a copy of the net) or writing it in place
    (``copy_``, ``load_state_dict``) packs again.  The kept tensors hold
    their memory, so an address is not reused while it is part of a
    fingerprint.  A write through ``p.data`` in place (``p.data.copy_``)
    bypasses the version counter, and is not seen."""
    sources = [getattr(net, name) for name, _size in LAYOUT]
    key = tuple((t.data_ptr(), t._version) for t in sources)
    hit = _PACKED.get(net)
    if hit is None or hit[0] != key:
        tensors = {name: t.detach() for (name, _size), t in zip(LAYOUT, sources)}
        hit = (key, tensors, pack(tensors))
        _PACKED[net] = hit
    return hit[2]


def value_net_cuda(net, x: torch.Tensor) -> torch.Tensor:
    """``[...]`` raw values of ``[..., 31]`` rows ``x`` by one launch of the
    kernel on the current stream (no synchronise).  ``net`` is a
    ``CADRLValueNet`` on ``x``'s device."""
    for name, shape in WIDTHS.items():
        if tuple(getattr(net, name).shape) != shape:
            raise ValueError(f"the kernel takes {name} of {shape}, got "
                             f"{tuple(getattr(net, name).shape)}")
    KERNEL.check(net.dtype)
    if x.dim() < 1 or x.shape[-1] != WIDTHS["W0"][0]:
        raise ValueError(f"x must be [..., 31], got {tuple(x.shape)}")
    weights = packed(net)
    build.check_launch_args([("x", x, net.dtype, x.shape),
                             ("packed", weights, net.dtype, weights.shape)], x.device)
    y = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    rows = y.numel()
    if rows == 0:
        return y
    KERNEL(net.dtype, weights.data_ptr(), x.data_ptr(), y.data_ptr(), rows, device=x.device)
    return y
