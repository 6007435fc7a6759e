"""SARL's value network: the attention-pooling crowd-navigation value net
of Chen, Liu, Kreiss and Alahi, "Crowd-Robot Interaction: Crowd-aware Robot
Navigation with Attention-based Deep Reinforcement Learning" (ICRA 2019,
arXiv:1809.08835), as the public CrowdNav code builds it
(``crowd_nav/policy/sarl.py:ValueNetwork``, ``configs/policy.config``
``[sarl]``: ``with_global_state = true``, ``with_om = false``).

For one candidate row with others j (each pair's 13 rotated features
``x_j``, the ego's 6 ``self``)::

    e_j = mlp1(x_j)                      13 -> 150 -> 100, ReLU after both
    h_j = mlp2(e_j)                      100 -> 100 -> 50
    m   = mean_j e_j                     the global state
    s_j = attention([e_j, m])            200 -> 100 -> 100 -> 1
    w_j = exp(s_j) [s_j != 0] / sum_k exp(s_k) [s_k != 0]
    V   = mlp3([self, sum_j w_j h_j])    56 -> 150 -> 100 -> 100 -> 1

The layers are CrowdNav's ``nn.Sequential`` stacks under its names
(``mlp1.0.weight``, ``attention.4.bias``, ...), so a CrowdNav state dict
loads as it is; the shipped ``models/weights/sarl_seeded.npz`` is a seeded
PyTorch default init (``scripts/make_sarl_weights.py``), not a trained net.
Absent others (an invalid agent, one beyond the sensing horizon) are left
out of the mean and of the softmax's sum; a row with no other pools
nothing (``m`` and the pooled features zero).

:func:`forward_raw` sends CUDA tensors to one launch of a hand-written
kernel (``ops/sarl_value.py``, ``csrc/sarl_value.cu``: FP32 FMAs on the CUDA
cores, every intermediate on chip) and CPU tensors to
:func:`forward_raw_plain`, plain PyTorch.  Both split the attention's first
layer into ``W_a e_j + (W_b m + b)``, so that the global state's half is
computed once a candidate row and not once a pair; the plain products run
in the net's dtype.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.ops import sarl_value

PAIR_DIM = 13
SELF_DIM = 6
MLP1 = (150, 100)
MLP2 = (100, 50)
ATTENTION = (100, 100, 1)
MLP3 = (150, 100, 100, 1)

_WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")
CHECKPOINTS = {"seeded": os.path.join(_WEIGHTS_DIR, "sarl_seeded.npz")}
# the seed of the shipped checkpoint's init
SEED = 1809

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _mlp(in_dim, dims, last_relu=False) -> nn.Sequential:
    """CrowdNav's ``mlp``: a Linear per width, a ReLU between them and, with
    ``last_relu``, after the last."""
    layers = []
    for i, (a, b) in enumerate(zip((in_dim,) + dims[:-1], dims)):
        layers.append(nn.Linear(a, b))
        if i < len(dims) - 1 or last_relu:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class SARLValueNet(nn.Module):
    """The four stacks at their published widths, about 96.5 k parameters,
    none requiring a gradient."""

    def __init__(self):
        super().__init__()
        self.mlp1 = _mlp(PAIR_DIM, MLP1, last_relu=True)
        self.mlp2 = _mlp(MLP1[-1], MLP2)
        self.attention = _mlp(2 * MLP1[-1], ATTENTION)
        self.mlp3 = _mlp(SELF_DIM + MLP2[-1], MLP3)
        self.requires_grad_(False)

    @property
    def dtype(self) -> torch.dtype:
        return self.mlp1[0].weight.dtype


def _dtype(dtype) -> torch.dtype:
    dtype = _DTYPES.get(dtype, dtype)
    if dtype not in _DTYPES.values():
        raise ValueError(f"the SARL value net takes float32 or float64, not {dtype}")
    return dtype


def init_params(seed: int = SEED, dtype=torch.float32, device=None) -> SARLValueNet:
    """A net with PyTorch's default ``nn.Linear`` init drawn from ``seed``,
    leaving the caller's random state as it was."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = SARLValueNet()
    return net.to(dtype=_dtype(dtype), device=device)


def load_params(path: str = "seeded", dtype=torch.float32, device=None) -> SARLValueNet:
    """A checkpoint (a name of :data:`CHECKPOINTS` or the path of an ``.npz``
    holding CrowdNav's state-dict names) as a net of ``dtype`` on ``device``
    (``None`` means CUDA)."""
    device = resolve_device(device)
    net = SARLValueNet()
    with np.load(CHECKPOINTS.get(path, path)) as z:
        net.load_state_dict({k: torch.as_tensor(z[k]) for k in z.files})
    return net.to(dtype=_dtype(dtype), device=device)


def forward_raw(net: SARLValueNet, pairs, present, self_state):
    """V of every candidate row.

    Args:
        pairs: ``[..., P, 13]`` rotated pair features.
        present: ``[..., P]`` bool (broadcast over the leading axes), which
            others are there.
        self_state: ``[..., 6]`` the rows' rotated ego features.

    Returns ``[...]``, the value net's raw output.  CPU tensors ->
    :func:`forward_raw_plain`; CUDA tensors -> one launch of the kernel
    (``ops/sarl_value.py:value_net_cuda``), which raises on inputs of
    another dtype than the net's or not contiguous, and on more others than
    a tile holds (128 in float32, 64 in float64).
    """
    if pairs.device.type == "cpu":
        return forward_raw_plain(net, pairs, present, self_state)
    if pairs.device.type == "cuda":
        return sarl_value.value_net_cuda(net, pairs, present, self_state)
    raise ValueError(f"no SARL value net for device {pairs.device}")


def forward_raw_plain(net: SARLValueNet, pairs, present, self_state):
    """:func:`forward_raw` in plain PyTorch: one product per layer over
    every pair or candidate row."""
    lead = self_state.shape[:-1]
    P = pairs.shape[-2]
    x = pairs.reshape(-1, P, PAIR_DIM)
    R = x.shape[0]
    there = present.expand(*lead, P).reshape(R, P, 1)
    l11, l12 = net.mlp1[0], net.mlp1[2]
    e = F.linear(F.linear(x, l11.weight, l11.bias).relu_(), l12.weight, l12.bias).relu_()
    l21, l22 = net.mlp2[0], net.mlp2[2]
    h = F.linear(F.linear(e, l21.weight, l21.bias).relu_(), l22.weight, l22.bias)
    count = there.sum(dim=1).to(e.dtype)
    m = torch.where(there, e, 0.0).sum(dim=1) / count.clamp(min=1.0)
    l31, l32, l33 = net.attention[0], net.attention[2], net.attention[4]
    G = e.shape[-1]
    a = F.linear(e, l31.weight[:, :G])
    a += F.linear(m, l31.weight[:, G:], l31.bias)[:, None, :]
    a = F.linear(a.relu_(), l32.weight, l32.bias).relu_()
    s = F.linear(a, l33.weight, l33.bias)
    scores = torch.where(there & (s != 0), torch.exp(s), 0.0)
    total = scores.sum(dim=1, keepdim=True)
    w = torch.where(total > 0, scores / total, 0.0)
    pooled = (w * h).sum(dim=1)
    v = net.mlp3(torch.cat([self_state.reshape(R, SELF_DIM), pooled], dim=-1))
    return v.reshape(lead)
