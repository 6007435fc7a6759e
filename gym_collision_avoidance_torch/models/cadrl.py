"""SA-CADRL value network (port of
:mod:`gym_collision_avoidance_tpu.models.cadrl`).

The reference's hand-rolled numpy MLP
(``neural_network_regr_multi.make_prediction_raw``,
neural_networks/neural_network_regr_multi.py:726-820) for the shipped
4-agent net::

    x[31] -> standardise -> Dense(200)+ReLU -> Dense(200)+ReLU
          -> block-max over the 3 other-agent 50-blocks (host 50 kept) -> 100
          -> Dense(50)+ReLU -> Dense(1) -> de-standardise

:class:`CADRLValueNet` holds the weights in the JAX package's layout
(kernels ``[in, out]``, the same names as its parameter dict).  The JAX
package's TPU padding (``pad_params_tpu``) is a workaround for the TPU's lane
width and is not ported.  Standardisation follows the JAX serving step: with
the weights closed over, XLA folds ``(x - avg) / std`` into
``(x - avg) * (1 / std)`` (compiled HLO), so the port multiplies by the
reciprocal rounded to the weights' dtype.

:func:`forward_raw` runs the plain PyTorch version,
:func:`forward_raw_plain`, on a CPU tensor, and on a CUDA tensor one launch
of the hand-written kernel ``csrc/cadrl_value.cu``
(``ops/cadrl_value.py``), which reads the weights in its own layout, packed
once and again only after a weight changes.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.ops import cadrl_value

INPUT_DIM = 31
HOST_BLOCK = 50
OTHER_BLOCK = 50
NUM_OTHER_SLOTS = 3

WEIGHT_NAMES = ("W0", "b0", "W1", "b1", "W3", "b3", "W4", "b4")
NORM_NAMES = ("avg_vec", "std_vec", "output_avg", "output_std")

_WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")

# The two SA-CADRL value nets the reference ships (CADRL/pickle_files/multi/):
# "no_constr" is what CADRLPolicy loads by default (CADRLPolicy.py:23);
# "rotate_constr_right" is the alternative at CADRLPolicy.py:22, run with
# cfg.cadrl_mode="rotate_constr" and cfg.cadrl_passing_side="right".
CHECKPOINTS = {
    "no_constr": os.path.join(_WEIGHTS_DIR, "cadrl_4agent_iter1000.npz"),
    "rotate_constr_right": os.path.join(_WEIGHTS_DIR,
                                        "cadrl_4agent_rotate_constr_right_iter1300.npz"),
}

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class CADRLValueNet(nn.Module):
    """The value net's weights (``W0 [31, 200]``, ``W1 [200, 200]``,
    ``W3 [100, 50]``, ``W4 [50, 1]`` and biases) and its standardisation
    constants, all in one dtype, plus ``inv_std``, ``1 / std_vec`` rounded
    to that dtype.

    Args:
        arrays: ``{name: array}`` with the names of :data:`WEIGHT_NAMES` and
            :data:`NORM_NAMES` (an ``.npz`` checkpoint, or the JAX package's
            parameter dict as numpy arrays).
        dtype: float32 or float64; ``None`` keeps that of ``arrays["W0"]``.
    """

    def __init__(self, arrays: Mapping[str, np.ndarray], dtype=None):
        super().__init__()
        if dtype is None:
            dtype = _DTYPES[np.asarray(arrays["W0"]).dtype.name]
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        for name in WEIGHT_NAMES:
            self.register_parameter(name, nn.Parameter(
                torch.as_tensor(np.array(arrays[name], np_dtype)), requires_grad=False))
        for name in NORM_NAMES:
            self.register_buffer(name, torch.as_tensor(np.array(arrays[name], np_dtype)))
        std = np.array(arrays["std_vec"], np_dtype)
        self.register_buffer("inv_std", torch.as_tensor(np_dtype(1.0) / std))

    @property
    def dtype(self) -> torch.dtype:
        return self.W0.dtype

    def forward_raw(self, x):
        return forward_raw(self, x)


def load_params(path: str = "no_constr", dtype=torch.float32, device=None) -> CADRLValueNet:
    """Load a checkpoint (a name of :data:`CHECKPOINTS` or a path) as a
    :class:`CADRLValueNet` of ``dtype`` (float32 or float64) on ``device``
    (``None`` means CUDA)."""
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    if dtype not in _DTYPES.values():
        raise ValueError(f"the CADRL value net takes float32 or float64, not {dtype}")
    device = resolve_device(device)
    with np.load(CHECKPOINTS.get(path, path)) as z:
        arrays = {k: z[k] for k in z.files}
    return CADRLValueNet(arrays, dtype).to(device)


def forward_raw(params: CADRLValueNet, x):
    """Raw value of ``[..., 31]`` unstandardised agent-centric states ->
    ``[...]`` (before the callers' [-0.25, 1] clip and gamma bound,
    nn_navigation_value_multi.py:2052-2100).

    CPU tensors -> :func:`forward_raw_plain`; CUDA tensors -> one launch of
    the kernel (``ops/cadrl_value.py:value_net_cuda``), which raises on a
    non-contiguous ``x`` or one of another dtype than the net's."""
    if x.device.type == "cpu":
        return forward_raw_plain(params, x)
    if x.device.type == "cuda":
        return cadrl_value.value_net_cuda(params, x)
    raise ValueError(f"no CADRL value net for device {x.device}")


def forward_raw_plain(params: CADRLValueNet, x):
    """:func:`forward_raw` in plain PyTorch: one product per layer over all
    leading axes."""
    xn = (x - params.avg_vec) * params.inv_std
    h = torch.relu(torch.matmul(xn, params.W0) + params.b0)
    h = torch.relu(torch.matmul(h, params.W1) + params.b1)
    # max layer (layers_info [[1, 50], [3, 50]]): the host block passes
    # through, the three other-agent blocks reduce elementwise
    host = h[..., :HOST_BLOCK]
    o = HOST_BLOCK
    pooled = torch.maximum(torch.maximum(h[..., o:o + OTHER_BLOCK],
                                         h[..., o + OTHER_BLOCK:o + 2 * OTHER_BLOCK]),
                           h[..., o + 2 * OTHER_BLOCK:o + 3 * OTHER_BLOCK])
    z = torch.relu(torch.matmul(torch.cat([host, pooled], dim=-1), params.W3) + params.b3)
    y = torch.matmul(z, params.W4) + params.b4
    return (y * params.output_std + params.output_avg)[..., 0]
