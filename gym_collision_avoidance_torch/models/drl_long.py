"""DRL-Long (Long et al. 2018) CNN policy (port of
:mod:`gym_collision_avoidance_tpu.models.drl_long`).

The reference wraps a PyTorch ``CNNPolicy`` from its DRL_Long submodule
(``envs/policies/DRLLongPolicy.py:14, 46``; the public
``Acmece/rl-collision-avoidance`` implementation)::

    scan [B, 3, L] -> Conv1d(3->32, k5, s2, p1) + ReLU
                   -> Conv1d(32->32, k3, s2, p1) + ReLU
                   -> flatten -> Dense(256) + ReLU
    concat([fc_scan, goal(2), speed(2)]) -> Dense(128) + ReLU
    actor mean = [sigmoid(actor1), tanh(actor2)]

The reference ships the submodule empty; the JAX package trained the net
from scratch (its ``drl_long_2agent_rvo_tpu.npz``, copied byte for byte into
``models/weights/``), with a critic head and a Gaussian log-std for PPO.
:class:`DRLLongNet` is built from the JAX package's parameter layout (dense
kernels ``[in, out]``, which ``nn.Linear`` holds transposed), so a
checkpoint, a seeded init and the JAX package's parameter dict all load the
same way.  On the card ``core.device.resolve_device`` turns TF32 off, so the
products, and cuDNN's convolutions where autograd takes them, run in
float32; the convolution kernel ignores TF32.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

from gym_collision_avoidance_torch.core import maths
from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.ops import drl_long_conv

FRAMES = 3

_WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")
CHECKPOINTS = {"2agent_rvo_tpu": os.path.join(_WEIGHTS_DIR, "drl_long_2agent_rvo_tpu.npz")}

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_DENSE = ("fc1", "fc2", "actor1", "actor2", "critic")


def conv_out_len(L, k, s, p):
    return (L + 2 * p - k) // s + 1


class DRLLongNet(nn.Module):
    """The CNN trunk and actor heads; the ``critic`` head and ``log_std``
    when ``arrays`` holds them (the shipped checkpoint and
    :func:`init_actor_critic_params` do).

    Args:
        arrays: ``{name: array}`` in the JAX package's names (``conv1_w``
            ``[32, 3, 5]``, ``fc1_w`` ``[in, out]``, ...).
        dtype: float32 or float64; ``None`` keeps that of ``conv1_w``.
    """

    def __init__(self, arrays: Mapping[str, np.ndarray], dtype=None):
        super().__init__()
        if dtype is None:
            dtype = _DTYPES[np.asarray(arrays["conv1_w"]).dtype.name]

        def t(name, transpose=False):
            a = np.asarray(arrays[name])
            return torch.as_tensor(np.array(a.T if transpose else a)).to(dtype)

        self.conv1 = nn.Conv1d(FRAMES, 32, 5, 2, 1, dtype=dtype)
        self.conv2 = nn.Conv1d(32, 32, 3, 2, 1, dtype=dtype)
        layers = {"conv1": self.conv1, "conv2": self.conv2}
        for name in _DENSE:
            if f"{name}_w" in arrays:
                w = np.asarray(arrays[f"{name}_w"])
                layers[name] = nn.Linear(w.shape[0], w.shape[1], dtype=dtype)
                setattr(self, name, layers[name])
        self.has_critic = "critic" in layers
        with torch.no_grad():
            for name, layer in layers.items():
                layer.weight.copy_(t(f"{name}_w", transpose=name not in ("conv1", "conv2")))
                layer.bias.copy_(t(f"{name}_b"))
        if "log_std" in arrays:
            self.log_std = nn.Parameter(t("log_std"))
        self.requires_grad_(False)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1.weight.dtype

    def trunk(self, scan_stack, goal, speed):
        """``[B, 128]`` features of ``[B, 3, L]`` scans, ``[B, 2]`` goals and
        speeds, cast to the net's dtype.  The two convolutions with their
        biases and ReLUs are one launch of ``csrc/drl_long_conv.cu`` on a CUDA
        tensor when no gradient is asked for (``ops/drl_long_conv.py``), and
        the ``nn.Conv1d`` layers otherwise: on the CPU, and for the PPO
        trainer, whose net requires gradients."""
        dtype = self.dtype
        x = scan_stack.to(dtype)
        if x.is_cuda and not drl_long_conv.needs_grad(self, x):
            h = drl_long_conv.drl_long_conv_cuda(self, x.contiguous())
        else:
            h = drl_long_conv.drl_long_conv_plain(self, x)
        h = torch.relu(self.fc1(h.reshape(h.shape[0], -1)))
        return torch.relu(self.fc2(torch.cat([h, goal.to(dtype), speed.to(dtype)], dim=-1)))

    def forward(self, scan_stack, goal, speed):
        return forward(self, scan_stack, goal, speed)


def forward(params: DRLLongNet, scan_stack, goal, speed):
    """Mean action ``[B, 2]``: v in [0, 1] (sigmoid), omega in [-1, 1]
    (tanh).  ``scan_stack`` is ``[B, 3, L]`` normalised scans
    (scan / 6 - 0.5), oldest frame first (DRLLongPolicy.py:81-87); ``goal``
    the goal in the body frame and ``speed`` the velocity, ``[B, 2]``."""
    z = params.trunk(scan_stack, goal, speed)
    return torch.cat([torch.sigmoid(params.actor1(z)), torch.tanh(params.actor2(z))], dim=-1)


def forward_actor_critic(params: DRLLongNet, scan_stack, goal, speed):
    """(mean ``[B, 2]`` in [0, 1]^2, log_std ``[B, 2]``, value ``[B]``), the
    training form: the omega head's tanh is remapped (w + 1) / 2 into the
    LearningPolicy action box (LearningPolicy.py:13)."""
    if not params.has_critic:
        raise ValueError("forward_actor_critic needs a net with a critic head and log_std "
                         "(init_actor_critic_params or the shipped checkpoint)")
    z = params.trunk(scan_stack, goal, speed)
    v = torch.sigmoid(params.actor1(z))
    w = torch.tanh(params.actor2(z))
    mean = torch.cat([v, (w + 1.0) * 0.5], dim=-1)
    value = params.critic(z)[:, 0]
    # jnp.clip's gradient: 0.5 at a bound (maths.clip), as the JAX trainer sees it
    log_std = maths.clip(params.log_std, -4.0, 0.0).expand_as(mean)
    return mean, log_std, value


def jax_named_parameters(params: DRLLongNet) -> dict:
    """``{name: parameter}`` under the JAX package's names (``conv1_w``,
    ``fc1_b``, ..., ``log_std``).  The dense ``*_w`` tensors are
    ``nn.Linear``'s ``[out, in]`` weights, the transpose of JAX's
    ``[in, out]``."""
    out = {}
    for layer in ("conv1", "conv2") + _DENSE:
        module = getattr(params, layer, None)
        if module is not None:
            out[f"{layer}_w"], out[f"{layer}_b"] = module.weight, module.bias
    if hasattr(params, "log_std"):
        out["log_std"] = params.log_std
    return out


def is_dense_weight(name: str) -> bool:
    """Whether the JAX package's ``name`` is a dense kernel, which
    :class:`DRLLongNet` holds transposed."""
    return name.endswith("_w") and name[:-2] in _DENSE


def _init_arrays(laserscan_length: int, seed: int, np_dtype):
    """The JAX package's seeded He init (``init_params``), drawn from
    ``np.random.RandomState(seed)`` in the same order, as numpy arrays."""
    rng = np.random.RandomState(seed)
    L2 = conv_out_len(conv_out_len(laserscan_length, 5, 2, 1), 3, 2, 1)
    flat = 32 * L2

    def he(shape, fan_in):
        return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    p = {
        "conv1_w": he((32, FRAMES, 5), FRAMES * 5),
        "conv1_b": np.zeros(32, np.float32),
        "conv2_w": he((32, 32, 3), 32 * 3),
        "conv2_b": np.zeros(32, np.float32),
        "fc1_w": he((flat, 256), flat),
        "fc1_b": np.zeros(256, np.float32),
        "fc2_w": he((256 + 4, 128), 260),
        "fc2_b": np.zeros(128, np.float32),
        "actor1_w": he((128, 1), 128),
        "actor1_b": np.zeros(1, np.float32),
        "actor2_w": he((128, 1), 128),
        "actor2_b": np.zeros(1, np.float32),
    }
    return {k: v.astype(np_dtype) for k, v in p.items()}


def _np_dtype(dtype):
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    if dtype not in _DTYPES.values():
        raise ValueError(f"DRL-Long takes float32 or float64, not {dtype}")
    return dtype, (np.float32 if dtype == torch.float32 else np.float64)


def init_params(laserscan_length: int = 512, seed: int = 0, dtype=torch.float32,
                device=None) -> DRLLongNet:
    """Seeded random actor (He init), the same weights as the JAX
    package's ``init_params`` with the same seed.  ``device=None`` means
    CUDA."""
    dtype, np_dtype = _np_dtype(dtype)
    device = resolve_device(device)
    return DRLLongNet(_init_arrays(laserscan_length, seed, np_dtype), dtype).to(device)


def init_actor_critic_params(laserscan_length: int = 512, seed: int = 0,
                             dtype=torch.float32, device=None) -> DRLLongNet:
    """The trainable actor-critic of the JAX package's
    ``init_actor_critic_params``: :func:`init_params`' trunk and heads with
    the actor heads scaled by 1e-2, a critic head drawn from
    ``RandomState(seed + 1)`` and ``log_std`` -1.2."""
    dtype, np_dtype = _np_dtype(dtype)
    device = resolve_device(device)
    rng = np.random.RandomState(seed + 1)
    p = _init_arrays(laserscan_length, seed, np_dtype)
    p["actor1_w"] = p["actor1_w"] * 1e-2
    p["actor2_w"] = p["actor2_w"] * 1e-2
    p["critic_w"] = np.asarray(
        rng.randn(128, 1).astype(np.float32) * np.sqrt(2.0 / 128) * 1e-1, np_dtype)
    p["critic_b"] = np.zeros((1,), np_dtype)
    p["log_std"] = np.full((2,), -1.2, np_dtype)
    return DRLLongNet(p, dtype).to(device)


def load_params(path: str = "2agent_rvo_tpu", dtype=torch.float32, device=None) -> DRLLongNet:
    """Load a checkpoint (a name of :data:`CHECKPOINTS` or a path) as a
    :class:`DRLLongNet` on ``device`` (``None`` means CUDA)."""
    dtype, _ = _np_dtype(dtype)
    device = resolve_device(device)
    with np.load(CHECKPOINTS.get(path, path)) as z:
        arrays = {k: z[k] for k in z.files}
    return DRLLongNet(arrays, dtype).to(device)


def convert_torch_state_dict(state_dict) -> dict:
    """Map the public repo's ``CNNPolicy`` state dict onto the JAX package's
    parameter names, as float32 numpy arrays (dense weights transposed to
    ``[in, out]``); :class:`DRLLongNet` takes the result."""
    names = {
        "act_fea_cv1.weight": "conv1_w", "act_fea_cv1.bias": "conv1_b",
        "act_fea_cv2.weight": "conv2_w", "act_fea_cv2.bias": "conv2_b",
        "act_fc1.weight": "fc1_w", "act_fc1.bias": "fc1_b",
        "act_fc2.weight": "fc2_w", "act_fc2.bias": "fc2_b",
        "actor1.weight": "actor1_w", "actor1.bias": "actor1_b",
        "actor2.weight": "actor2_w", "actor2.bias": "actor2_b",
    }
    out = {}
    for key, name in names.items():
        if key not in state_dict:
            continue
        w = state_dict[key]
        w = np.asarray(w.detach().cpu().numpy() if torch.is_tensor(w) else w)
        if name.endswith("_w") and w.ndim == 2:
            w = w.T  # torch Linear stores [out, in]
        out[name] = np.array(w, np.float32)
    return out
