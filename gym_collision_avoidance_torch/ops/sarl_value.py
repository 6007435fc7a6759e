"""SARL's value net in one launch of a hand-written CUDA kernel.

``csrc/sarl_value.cu`` (``sarl_value_gemm_kernel``) computes the whole of
``models/sarl.py:forward_raw_plain`` (mlp1 and mlp2 of every pair, the
masked global mean, the attention, the masked softmax, the pooling and
mlp3) for ``[R, P, 13]`` pairs, their present mask and ``[R, 6]`` ego rows,
keeping every intermediate in registers and shared memory.  It replaces no
Pallas kernel: the JAX package has no SARL (see the note at the top of the
source for why it was added and what bounds it).

* :func:`pack`: the weights in the layout the kernel reads; :func:`packed`
  keeps a net's packed copy and packs it again whenever one of its source
  tensors has been replaced or written in place since;
* :func:`value_net_cuda`: one launch on the current stream.  It raises on a
  net of other widths, on inputs of another dtype than the net's, of other
  shapes or not contiguous, on more others than a tile holds
  (:data:`MAX_OTHERS`), and on a launch error; it allocates only its output.

``models/sarl.py:forward_raw`` sends CUDA tensors here and CPU tensors to
the plain version.
"""

from __future__ import annotations

import ctypes
import math
import weakref

import torch
from torch.nn import functional as F

from gym_collision_avoidance_torch.ops import build

PAIR_DIM, SELF_DIM = 13, 6
GROUPS = 8        # column groups of a pair product


def _cols(n):
    """A pair product's columns a thread for n outputs, and their group's
    width padded to 16 bytes (the source's ``cols`` and ``pad4``)."""
    cols = -(-n // GROUPS)
    return cols, -(-cols // 4) * 4


NC150, PAD150 = _cols(150)     # mlp1.0, mlp3.0
NC100, PAD100 = _cols(100)     # mlp1.2, mlp3.2, mlp3.4
NC200, PAD200 = _cols(200)     # mlp2.0 | attention.0's e half
NC50 = _cols(50)[0]            # mlp2.2, beside attention.2's NC100
PAD_DUAL = -(-(NC50 + NC100) // 4) * 4
# the net's Linear layers, (in, out), by CrowdNav's names
WIDTHS = {"mlp1.0": (13, 150), "mlp1.2": (150, 100), "mlp2.0": (100, 100),
          "mlp2.2": (100, 50), "attention.0": (200, 100), "attention.2": (100, 100),
          "attention.4": (100, 1), "mlp3.0": (56, 150), "mlp3.2": (150, 100),
          "mlp3.4": (100, 100), "mlp3.6": (100, 1)}
# the most others a candidate row may have: a tile's pair rows
MAX_OTHERS = {torch.float32: 128, torch.float64: 64}

KERNEL = build.Kernel("sarl_value", "sarl_value",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3)
# net -> (fingerprint of its tensors, those tensors, their packed copy)
_PACKED = weakref.WeakKeyDictionary()


def _weight(t, name):
    """Layer ``name``'s weight as ``[in, out]``."""
    return t[name + ".weight"].t()


def _grouped(mats, pad):
    """``[K, GROUPS, pad]``: group g holds, for each ``(w [K, N], cols)`` of
    ``mats`` in turn, columns ``cols g .. cols g + cols - 1`` of ``w`` (zeros
    past N), then zeros up to ``pad``."""
    parts = [F.pad(w, (0, GROUPS * cols - w.shape[1])).reshape(w.shape[0], GROUPS, cols)
             for w, cols in mats]
    joined = torch.cat(parts, dim=-1)
    return F.pad(joined, (0, pad - joined.shape[-1]))


def _vector(v, size):
    return F.pad(v.reshape(-1), (0, size - v.numel()))


# The packed buffer, piece by piece in the kernel's order (its source note):
# (name, elements, builder from {state-dict name: tensor}).  The streamed
# pieces come first, in the order a tile reads them, then the resident ones.
LAYOUT = (
    ("W12", 150 * GROUPS * PAD100,
     lambda t: _grouped([(_weight(t, "mlp1.2"), NC100)], PAD100)),
    ("W21|Wa|Wb", 100 * (GROUPS * PAD200 + 100), lambda t: torch.cat([_grouped(
        [(torch.cat([_weight(t, "mlp2.0"), _weight(t, "attention.0")[:100]], dim=1), NC200)],
        PAD200).reshape(100, -1), _weight(t, "attention.0")[100:]], dim=1)),
    ("W22|W_a2", 100 * GROUPS * PAD_DUAL, lambda t: _grouped(
        [(_weight(t, "mlp2.2"), NC50), (_weight(t, "attention.2"), NC100)], PAD_DUAL)),
    ("W30", 56 * GROUPS * PAD150, lambda t: _grouped([(_weight(t, "mlp3.0"), NC150)], PAD150)),
    ("W31", 150 * GROUPS * PAD100,
     lambda t: _grouped([(_weight(t, "mlp3.2"), NC100)], PAD100)),
    ("W32", 100 * GROUPS * PAD100,
     lambda t: _grouped([(_weight(t, "mlp3.4"), NC100)], PAD100)),
    ("W11", 13 * GROUPS * PAD150, lambda t: _grouped([(_weight(t, "mlp1.0"), NC150)], PAD150)),
    ("b11", 152, lambda t: _vector(t["mlp1.0.bias"], 152)),
    ("b12", 100, lambda t: t["mlp1.2.bias"]),
    ("b21", 100, lambda t: t["mlp2.0.bias"]),
    ("b22", 52, lambda t: _vector(t["mlp2.2.bias"], 52)),
    ("b_a1", 100, lambda t: t["attention.0.bias"]),
    ("b_a2", 100, lambda t: t["attention.2.bias"]),
    ("w_a3", 100, lambda t: t["attention.4.weight"]),
    ("b_a3", 4, lambda t: _vector(t["attention.4.bias"], 4)),
    ("b30", 152, lambda t: _vector(t["mlp3.0.bias"], 152)),
    ("b31", 100, lambda t: t["mlp3.2.bias"]),
    ("b32", 100, lambda t: t["mlp3.4.bias"]),
    ("w33", 100, lambda t: t["mlp3.6.weight"]),
    ("b33", 4, lambda t: _vector(t["mlp3.6.bias"], 4)),
)


def pack(tensors):
    """The 1-D buffer the kernel reads, from ``{name: tensor}`` of the
    net's state-dict names (nn.Linear's ``[out, in]`` weights), in their
    dtype and on their device."""
    pieces = []
    for name, size, build_piece in LAYOUT:
        piece = build_piece(tensors).reshape(-1)
        if piece.numel() != size:
            raise ValueError(f"piece {name}: {piece.numel()} elements, the kernel reads {size}")
        pieces.append(piece)
    return torch.cat(pieces)


def packed(net) -> torch.Tensor:
    """:func:`pack` of a ``SARLValueNet``'s tensors, packed once and kept
    until one of them changes: the fingerprint is each tensor's
    ``(data_ptr(), _version)``, so replacing a tensor (``p.data = ...``,
    ``.to``, ``.double()``, a copy of the net) or writing it in place
    (``copy_``, ``load_state_dict``) packs again.  The kept tensors hold
    their memory, so an address is not reused while it is part of a
    fingerprint.  A write through ``p.data`` in place (``p.data.copy_``)
    bypasses the version counter, and is not seen."""
    sources = dict(net.state_dict(keep_vars=True))
    key = tuple((t.data_ptr(), t._version) for t in sources.values())
    hit = _PACKED.get(net)
    if hit is None or hit[0] != key:
        tensors = {name: t.detach() for name, t in sources.items()}
        hit = (key, tensors, pack(tensors))
        _PACKED[net] = hit
    return hit[2]


def _check_widths(net) -> None:
    """Raise ``ValueError`` unless ``net``'s layers have the published widths."""
    for name, (fan_in, fan_out) in WIDTHS.items():
        stack, index = name.split(".")
        layer = getattr(net, stack)[int(index)]
        if tuple(layer.weight.shape) != (fan_out, fan_in):
            raise ValueError(f"the kernel takes {name} of {fan_in} -> {fan_out}, got "
                             f"{tuple(layer.weight.shape[::-1])}")


def mask_rows(present, lead, others):
    """``(rows, group)``: ``present`` broadcast to ``lead + (others,)`` as
    contiguous ``[R / group, others]`` rows, each shared by ``group``
    consecutive candidate rows (the product of the trailing axes along which
    it is broadcast; copied only where the others are not contiguous)."""
    mask = present.expand(*lead, others)
    group = 1
    while mask.dim() > 1 and (mask.shape[-2] == 1 or mask.stride(-2) == 0):
        group *= mask.shape[-2]
        mask = mask.select(-2, 0)
    return mask.reshape(math.prod(mask.shape[:-1]), others).contiguous(), group


def value_net_cuda(net, pairs: torch.Tensor, present: torch.Tensor,
                   self_state: torch.Tensor) -> torch.Tensor:
    """``[...]`` raw values of ``[..., P, 13]`` pairs, their ``[..., P]``
    bool present mask (broadcast over the leading axes) and ``[..., 6]`` ego
    rows by one launch of the kernel on the current stream (no
    synchronise).  ``net`` is a ``SARLValueNet`` on the inputs' device."""
    _check_widths(net)
    dtype = net.dtype
    KERNEL.check(dtype)
    if pairs.dim() < 2 or pairs.shape[-1] != PAIR_DIM:
        raise ValueError(f"pairs must be [..., P, {PAIR_DIM}], got {tuple(pairs.shape)}")
    lead, others = tuple(pairs.shape[:-2]), pairs.shape[-2]
    if tuple(self_state.shape) != lead + (SELF_DIM,):
        raise ValueError(f"self_state must be {lead + (SELF_DIM,)}, got "
                         f"{tuple(self_state.shape)}")
    if others > MAX_OTHERS[dtype]:
        raise ValueError(f"the kernel takes at most {MAX_OTHERS[dtype]} others a row in "
                         f"{dtype}, got {others}")
    if present.dtype != torch.bool:
        raise TypeError(f"present must be torch.bool, got {present.dtype}")
    build.check_launch_args([("pairs", pairs, dtype, pairs.shape),
                             ("self_state", self_state, dtype, self_state.shape)], pairs.device)
    mask, group = mask_rows(present, lead, others)
    weights = packed(net)
    build.check_launch_args([("present", mask, torch.bool, mask.shape),
                             ("packed", weights, dtype, weights.shape)], pairs.device)
    y = torch.empty(lead, dtype=dtype, device=pairs.device)
    rows = y.numel()
    if rows == 0:
        return y
    KERNEL(dtype, weights.data_ptr(), pairs.data_ptr(), mask.data_ptr(), self_state.data_ptr(),
           y.data_ptr(), rows, group, others, device=pairs.device)
    return y
