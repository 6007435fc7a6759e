"""K1, the pairwise collision / nearest-gap kernel, for Hopper.

Port of the Pallas TPU kernel ``gym_collision_avoidance_tpu/ops/pairwise.py``
(``_kernel``).  Three pieces:

* :func:`pairwise_collisions_plain` -- the plain PyTorch version, written the
  way ``env/step.py:_pairwise_collisions`` is;
* the hand-written CUDA kernel ``csrc/pairwise.cu`` (see the note at its
  top for what bounds it and its exactness rules), bitwise equal to the
  plain version on the card;
* :func:`pairwise_collisions` -- the wrapper the env step calls.  A CPU
  tensor goes to the plain version; a CUDA tensor goes to the kernel, or
  the wrapper raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gym_collision_avoidance_torch.core.maths import sqrt_rn
from gym_collision_avoidance_torch.ops import build

# Kernel launches since import (or since a caller last set it to 0).
LAUNCHES = 0

_SYMBOLS = {torch.float32: "pairwise_collisions_f32",
            torch.float64: "pairwise_collisions_f64"}
_FUNCS = {}


def pairwise_collisions_plain(pos, radius, valid):
    """(collision [E, A] bool, nearest_gap [E, A]) in plain PyTorch.

    Args:
        pos: [E, A, 2]; radius: [E, A]; valid: [E, A] bool.
    """
    A = pos.shape[-2]
    rel = pos[:, None, :, :] - pos[:, :, None, :]                # [E, A, A, 2]
    dist = sqrt_rn(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
    combined_radius = radius[:, :, None] + radius[:, None, :]
    eye = torch.eye(A, dtype=torch.bool, device=pos.device)
    pair_valid = valid[:, :, None] & valid[:, None, :] & ~eye
    gap = torch.where(pair_valid, dist - combined_radius,
                      torch.full_like(dist, math.inf))
    nearest = torch.amin(gap, dim=-1)
    collision = torch.any(pair_valid & (dist <= combined_radius), dim=-1)
    return collision, nearest


def _kernel_func(dtype):
    fn = _FUNCS.get(dtype)
    if fn is None:
        fn = getattr(build.load("pairwise"), _SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCS[dtype] = fn
    return fn


def pairwise_collisions_cuda(pos, radius, valid):
    """Launch the CUDA kernel on the current stream (no synchronise)."""
    global LAUNCHES
    if pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"pos must be [E, A, 2], got {tuple(pos.shape)}")
    E, A = pos.shape[:2]
    if pos.dtype not in _SYMBOLS:
        raise TypeError(f"pos must be float32 or float64, got {pos.dtype}")
    build.check_launch_args([("pos", pos, pos.dtype, (E, A, 2)),
                             ("radius", radius, pos.dtype, (E, A)),
                             ("valid", valid, torch.bool, (E, A))], pos.device)
    collision = torch.empty((E, A), dtype=torch.bool, device=pos.device)
    nearest = torch.empty((E, A), dtype=pos.dtype, device=pos.device)
    err = _kernel_func(pos.dtype)(
        pos.data_ptr(), radius.data_ptr(), valid.data_ptr(),
        collision.data_ptr(), nearest.data_ptr(), E, A,
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pairwise_collisions kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return collision, nearest


def pairwise_collisions(pos, radius, valid):
    """(collision [E, A] bool, nearest_gap [E, A]) for an env batch.

    CPU tensors -> plain version; CUDA tensors -> the CUDA kernel.
    """
    if pos.device.type == "cpu":
        return pairwise_collisions_plain(pos, radius, valid)
    if pos.device.type == "cuda":
        return pairwise_collisions_cuda(pos, radius, valid)
    raise ValueError(f"no pairwise_collisions for device {pos.device}")
