"""SA-CADRL's one-step lookahead in one launch of a hand-written CUDA kernel.

``csrc/cadrl_lookahead.cu`` (``cadrl_lookahead_kernel``) computes what
``policies/cadrl.py:_lookahead_plain`` computes in ``cadrl_mode``
``"no_constr"`` with no passing side: from each ego agent's ``s10``, its
<= 3 selected others and their filtered actions, the 47 candidate actions,
the collision test, the shaped rewards, the propagated states, the
reached / needs-the-net flags, the closest-other reorder and the
agent-centric encoding, written as the contiguous ``[..., 47, 31]`` rows
that the value net reads.  No ``[..., 47, .]`` intermediate reaches device
memory.  It replaces no Pallas kernel: the JAX package leaves this stage to
XLA.  It gives the plain version's bits on the card in float32 (the note at
the top of the source says how).

* :func:`lookahead_cuda`: one launch on the current stream.  It raises on an
  input of another dtype, shape or device, or not contiguous, before anything
  is built, and on a launch error; it allocates only its outputs.

``policies/cadrl.py:_cadrl_prepare`` sends CUDA inputs here in that mode and
everything else to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gym_collision_avoidance_torch.ops import build

SLOTS, CANDIDATES, WIDTH = 3, 47, 31

KERNEL = build.Kernel("cadrl_lookahead", "cadrl_lookahead",
                      [ctypes.c_void_p] * 8 + [ctypes.c_int64])


def lookahead_cuda(s10, others_s10, others_action, present):
    """``(states_nn [..., 47, 31], aux)`` of ego states ``s10 [..., 10]``
    against ``others_s10 [..., 3, 10]``, ``others_action [..., 3, 2]`` and
    ``present [..., 3]`` (bool), by one launch of the kernel on the current
    stream (no synchronise).  ``aux`` holds ``action_speed``,
    ``action_heading``, ``action_valid``, ``action_rewards``, ``if_collide``,
    ``reached``, ``d_next`` and ``dist_col`` (``[..., 47]``) and
    ``dt_forward`` (``[...]``), as the plain version's."""
    dtype = s10.dtype
    KERNEL.check(dtype)
    lead = tuple(s10.shape[:-1])
    build.check_launch_args([
        ("s10", s10, dtype, (*lead, 10)),
        ("others_s10", others_s10, dtype, (*lead, SLOTS, 10)),
        ("others_action", others_action, dtype, (*lead, SLOTS, 2)),
        ("present", present, torch.bool, (*lead, SLOTS)),
    ], s10.device)
    device = s10.device
    states_nn = torch.empty((*lead, CANDIDATES, WIDTH), dtype=dtype, device=device)
    rows = torch.empty((4, *lead, CANDIDATES), dtype=dtype, device=device)
    flags = torch.empty((3, *lead, CANDIDATES), dtype=torch.bool, device=device)
    dt_forward = torch.empty(lead, dtype=dtype, device=device)
    n = math.prod(lead)
    if n > 0:
        KERNEL(dtype, s10.data_ptr(), others_s10.data_ptr(), others_action.data_ptr(),
               present.data_ptr(), states_nn.data_ptr(), rows.data_ptr(), flags.data_ptr(),
               dt_forward.data_ptr(), n, device=device)
    aux = {
        "action_speed": rows[0],
        "action_heading": rows[1],
        "action_valid": flags[0],
        "action_rewards": rows[2],
        "if_collide": flags[1],
        "reached": flags[2],
        "d_next": rows[3],
        "dist_col": states_nn[..., 0],
        "dt_forward": dt_forward,
    }
    return states_nn, aux
