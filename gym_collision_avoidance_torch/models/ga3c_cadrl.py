"""GA3C-CADRL policy network (port of
:mod:`gym_collision_avoidance_tpu.models.ga3c_cadrl`).

The reference's frozen TF1 graph (``envs/policies/GA3C_CADRL/network.py``)::

    X [B, 1 + 4 + MAX_OTHER*7]
      -> (X - avg) / std                       (baked-in normalisation)
      -> seq_len = int(X_norm[:, 0])           (num_other_agents; avg 0, std 1)
      -> host = X_norm[:, 1:5]
      -> others = X_norm[:, 5:].reshape(B, MAX_OTHER, 7)
      -> dynamic_rnn(LSTMCell(64), others, sequence_length=seq_len).state.h
      -> concat([host, h]) -> 3x Dense(256)+ReLU -> logits_p[11] / logits_v[1]
      -> softmax / squeeze

:class:`GA3CCADRL` holds the weights in the JAX package's layout (kernels
``[in, out]``, the same names as its parameter dict); the functions below take
it as ``params``, as the JAX functions take their dict.  The LSTM is a Python
loop over the (at most 19) other-agent slots with copy-through at
``t >= seq_len``, ``tf.nn.dynamic_rnn``'s ``sequence_length`` semantics.

Normalisation follows the compiled JAX step.  Serving closes over the
weights, and XLA folds ``x / std`` into ``x * (1 / std)``, so the serving form
multiplies by the reciprocal rounded to the input's dtype.  The JAX PPO
trainer passes the weights as arguments of its jitted step and trains
``input_avg`` and ``input_std`` with them, so there the quotient stays a
division: a net built with ``trainable=True`` (:func:`init_params`, the PPO
trainer's copy) holds all fourteen tensors as trainable parameters and
divides.  ``input_avg`` and ``input_std`` stay float32 whatever the weights'
dtype.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

from gym_collision_avoidance_torch.core.device import resolve_device

HIDDEN = 64
NUM_ACTIONS = 11

WEIGHT_NAMES = (
    "lstm_kernel", "lstm_bias",
    "layer1_kernel", "layer1_bias",
    "layer2_kernel", "layer2_bias",
    "fc1_kernel", "fc1_bias",
    "logits_p_kernel", "logits_p_bias",
    "logits_v_kernel", "logits_v_bias",
)
NORM_NAMES = ("input_avg", "input_std")

_WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")

# The checkpoints the JAX package ships (same names).  This package copies
# two of them into models/weights/: the default "iros18" (input width 138,
# 19 other-agent slots, the reference's GA3C-CADRL-10 net) and
# "ppo_selfplay_4agent_curr" (width 26, 3 slots).  The others are listed so
# that a config naming one fails on a missing file, not an unknown name.
CHECKPOINTS = {
    name: os.path.join(_WEIGHTS_DIR, f"{name}.npz" if name.startswith("ppo") else
                       f"ga3c_cadrl_{name}.npz")
    for name in ("iros18", "20190727_015942", "20190727_192048", "ppo_selfplay_2agent",
                 "ppo_selfplay_4agent_curr", "ppo_selfplay_6agent_curr",
                 "ppo_selfplay_10agent_curr", "ppo_selfplay_10agent_tpu")
}

_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def _as_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, as jax.device_get gives it
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, copy=True)).to(dtype)


class GA3CCADRL(nn.Module):
    """The GA3C-CADRL weights: LSTMCell(64) kernel ``[7 + 64, 256]`` and bias,
    ``layer1``/``layer2``/``fc1`` (Dense(256), ReLU), the ``logits_p[11]`` and
    ``logits_v[1]`` heads, and the float32 ``input_avg``/``input_std``
    buffers.

    Args:
        arrays: ``{name: array}`` with the names of :data:`WEIGHT_NAMES` and
            :data:`NORM_NAMES` (an ``.npz`` checkpoint, or the JAX package's
            parameter dict as numpy arrays).
        dtype: the weights' dtype (float32, float64 or bfloat16); ``None``
            keeps that of ``arrays["lstm_kernel"]``.
        trainable: the training form: every tensor, ``input_avg`` and
            ``input_std`` included, is a parameter that requires grad, and
            the normalisation divides (module docstring).
    """

    def __init__(self, arrays: Mapping[str, np.ndarray], dtype=None, trainable: bool = False):
        super().__init__()
        if dtype is None:
            dtype = _DTYPES[np.asarray(arrays["lstm_kernel"]).dtype.name]
        self.trainable = trainable
        for name in WEIGHT_NAMES:
            self.register_parameter(
                name, nn.Parameter(_as_tensor(arrays[name], dtype), requires_grad=trainable))
        for name in NORM_NAMES:
            norm = _as_tensor(arrays[name], torch.float32)
            if trainable:
                self.register_parameter(name, nn.Parameter(norm))
            else:
                self.register_buffer(name, norm)

    @property
    def width(self) -> int:
        """Input width ``5 + 7 * max_other`` of the checkpoint."""
        return self.input_avg.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.lstm_kernel.dtype

    def forward(self, x, max_seq_len: int | None = None):
        return forward(self, x, max_seq_len)


def load_params(path: str = "iros18", dtype=torch.float32, device=None) -> GA3CCADRL:
    """Load a checkpoint (a name of :data:`CHECKPOINTS` or a path) as a
    :class:`GA3CCADRL` on ``device`` (``None`` means CUDA).

    ``dtype`` is the weights' dtype: float32, float64 or bfloat16; the
    normalisation constants stay float32, as in the JAX loader.
    """
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    if dtype not in _DTYPES.values():
        raise ValueError(f"GA3C-CADRL weights take float32, float64 or bfloat16, not {dtype}")
    device = resolve_device(device)
    path = CHECKPOINTS.get(path, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return GA3CCADRL(arrays, dtype).to(device)


def init_params(generator: torch.Generator, max_other: int, dtype=torch.float32,
                device=None) -> GA3CCADRL:
    """Fresh trainable weights of the checkpoint architecture for
    ``max_other`` other-agent slots (the JAX package's ``init_params``):
    Glorot-uniform kernels drawn from ``generator`` (a CPU generator, so a
    seed gives the same weights on every device), zero biases, heads scaled
    by 1e-2, and the normalisation built from ``obs.spec.NORM_STATS`` with
    slot 0 at (0, 1), since the net reads ``num_other_agents`` raw as the
    LSTM's sequence length.  ``device=None`` means CUDA."""
    from gym_collision_avoidance_torch.obs import spec as obs_spec

    device = resolve_device(device)
    om, osd = obs_spec.NORM_STATS["other_agents_states"]
    avg = np.concatenate([[0.0, 0.0, 0.0, 1.0, 0.5], np.tile(om, max_other)]).astype(np.float32)
    std = np.concatenate([[1.0, 5.0, 3.14, 1.0, 1.0], np.tile(osd, max_other)]).astype(np.float32)

    def glorot(shape, scale=1.0):
        s = (6.0 / (shape[0] + shape[1])) ** 0.5
        w = torch.empty(shape, dtype=torch.float32).uniform_(-s, s, generator=generator)
        return (w * scale).numpy()

    H4 = 4 * HIDDEN
    zeros = lambda n: np.zeros((n,), np.float32)  # noqa: E731
    arrays = {
        "input_avg": avg, "input_std": std,
        "lstm_kernel": glorot((7 + HIDDEN, H4)), "lstm_bias": zeros(H4),
        "layer1_kernel": glorot((4 + HIDDEN, 256)), "layer1_bias": zeros(256),
        "layer2_kernel": glorot((256, 256)), "layer2_bias": zeros(256),
        "fc1_kernel": glorot((256, 256)), "fc1_bias": zeros(256),
        "logits_p_kernel": glorot((256, NUM_ACTIONS), 1e-2), "logits_p_bias": zeros(NUM_ACTIONS),
        "logits_v_kernel": glorot((256, 1), 1e-2), "logits_v_bias": zeros(1),
    }
    return GA3CCADRL(arrays, dtype, trainable=True).to(device)


def lstm_cell(params: GA3CCADRL, x_t, c, h):
    """One TF1 ``LSTMCell`` step (forget_bias 1.0, gate order [i, j, f, o])::

        gates = [x, h] @ kernel + bias
        c' = c * sigmoid(f + 1.0) + sigmoid(i) * tanh(j)
        h' = tanh(c') * sigmoid(o)
    """
    gates = torch.matmul(torch.cat([x_t, h], dim=-1), params.lstm_kernel) + params.lstm_bias
    i, j, f, o = torch.split(gates, HIDDEN, dim=-1)
    new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_c, new_h


def crop_to_width(x, width: int):
    """Zero-pad or crop the last axis to the checkpoint's input width
    (``NetworkVPCore.crop_x``, network.py:24-35)."""
    d = x.shape[-1]
    if d > width:
        return x[..., :width]
    if d < width:
        return torch.nn.functional.pad(x, (0, width - d))
    return x


def _normalize(x, avg, std, dtype, divide=False):
    """``(x - avg) / std`` in the promoted dtype, cast to ``dtype``: a
    product with the reciprocal as the JAX serving step computes it, or a
    quotient (``divide``) as its training step does."""
    std = std.to(torch.promote_types(x.dtype, std.dtype))
    if divide:
        return ((x - avg) / std).to(dtype)
    return ((x - avg) * torch.reciprocal(std)).to(dtype)


def forward(params: GA3CCADRL, x, max_seq_len: int | None = None):
    """Policy and value for a raw (unnormalised) obs batch.

    Args:
        x: ``[B, D]`` obs vectors ``[num_other_agents, dist_to_goal,
            heading_ego_frame, pref_speed, radius, (MAX_OTHER x 7)]``, padded
            or cropped to the checkpoint width.
        max_seq_len: cap on the LSTM length; when at most N others can be
            visible (N = agents - 1) the slots past N are copy-through
            anyway, so the cap is exact.

    Returns:
        (probs ``[B, 11]``, value ``[B]``)
    """
    width = params.width
    xn = _normalize(crop_to_width(x, width), params.input_avg, params.input_std, params.dtype,
                    params.trainable)
    B = xn.shape[0]
    max_other = (width - 5) // 7
    T = max_other if max_seq_len is None else min(max_other, max_seq_len)
    seq_len = xn[:, 0].to(torch.int32)
    others = xn[:, 5:5 + T * 7].reshape(B, T, 7)
    return _trunk(params, seq_len, xn[:, 1:5], others)


def _parts(params: GA3CCADRL, scalars, others, max_seq_len, sensor_slots):
    width = params.width
    K = others.shape[1]
    if 5 + 7 * (K if sensor_slots is None else sensor_slots) != width:
        raise ValueError(f"5 + 7 * slots must equal the checkpoint width {width} "
                         f"(K={K}, sensor_slots={sensor_slots}); use forward()")
    avg_o = params.input_avg[5:].reshape(-1, 7)[:K]
    std_o = params.input_std[5:].reshape(-1, 7)[:K]
    sn = _normalize(scalars, params.input_avg[:5], params.input_std[:5], params.dtype,
                    params.trainable)
    on = _normalize(others, avg_o, std_o, params.dtype, params.trainable)
    T = K if max_seq_len is None else min(K, max_seq_len)
    return sn[:, 0].to(torch.int32), sn[:, 1:5], on[:, :T]


def forward_parts(params: GA3CCADRL, scalars, others, max_seq_len: int | None = None,
                  sensor_slots: int | None = None):
    """:func:`forward` on ``[B, 5]`` scalars and ``[B, K, 7]`` other-agent
    rows, without the flat round trip.  ``sensor_slots`` is the sensor's
    full slot count when ``others`` arrives already cut to its first K rows
    (default K).  Only valid when ``5 + 7 * sensor_slots`` is the checkpoint
    width; otherwise use :func:`forward`."""
    return _trunk(params, *_parts(params, scalars, others, max_seq_len, sensor_slots))


def forward_parts_logits(params: GA3CCADRL, scalars, others, max_seq_len: int | None = None):
    """:func:`forward_parts` returning raw ``(logits_p, value)``, the form
    training losses use."""
    return trunk_raw(params, *_parts(params, scalars, others, max_seq_len, None))


def _trunk(params, seq_len, host, others):
    logits_p, value = trunk_raw(params, seq_len, host, others)
    return torch.softmax(logits_p, dim=-1), value


def trunk_raw(params: GA3CCADRL, seq_len, host, others):
    """The shared LSTM and dense trunk: ``others`` is ``[B, T, 7]``
    normalised, ``host`` ``[B, 4]``; returns ``(logits_p [B, 11],
    value [B])``.  ``T == 0`` leaves the zero state, as ``dynamic_rnn`` over
    an empty sequence does."""
    B, T = others.shape[0], others.shape[1]
    c = h = torch.zeros((B, HIDDEN), dtype=others.dtype, device=others.device)
    if T > 0:
        # the input side of every step in one product ([B, T, 7] @ [7, 4H]);
        # each row's dot is the one the JAX scan takes step by step
        x_gates = torch.matmul(others, params.lstm_kernel[:7]) + params.lstm_bias
        k_h = params.lstm_kernel[7:]
        for t in range(T):
            gates = x_gates[:, t] + torch.matmul(h, k_h)
            i, j, f, o = torch.split(gates, HIDDEN, dim=-1)
            new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
            new_h = torch.tanh(new_c) * torch.sigmoid(o)
            keep = (t < seq_len)[:, None]         # dynamic_rnn copy-through
            c = torch.where(keep, new_c, c)
            h = torch.where(keep, new_h, h)

    z = torch.cat([host, h], dim=-1)              # [B, 68]
    z = torch.relu(torch.matmul(z, params.layer1_kernel) + params.layer1_bias)
    z = torch.relu(torch.matmul(z, params.layer2_kernel) + params.layer2_bias)
    z = torch.relu(torch.matmul(z, params.fc1_kernel) + params.fc1_bias)
    logits_p = torch.matmul(z, params.logits_p_kernel) + params.logits_p_bias
    value = (torch.matmul(z, params.logits_v_kernel) + params.logits_v_bias)[:, 0]
    return logits_p, value
