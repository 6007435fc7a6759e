"""DRL-Long's two convolutions, with their biases and ReLUs, in one launch
of a hand-written CUDA kernel.

``csrc/drl_long_conv.cu`` (``drl_long_conv_gemm_kernel``) computes
``relu(conv2(relu(conv1(x))))`` of ``models/drl_long.py``'s net for ``[B, 3,
L]`` scans, keeping conv1's ``[B, 32, L1]`` output in shared memory; it
writes ``[B, 32, L2]`` in the channel-major order that ``fc1`` flattens.  It
replaces no Pallas kernel: the JAX package leaves this net to XLA.  It is
bound by float32 arithmetic (1 031 232 operations a row at L = 512 against
22 528 bytes); the note at the top of the source says how its design meets
that.  It sums in the order of the cuDNN kernel that the plain version runs,
so at 512 beams it gives the plain version's bits in float32 on the card.

* :func:`drl_long_conv_plain`: the plain version, the net's own
  ``nn.Conv1d`` layers and ``torch.relu`` (autograd included);
* :func:`drl_long_conv_cuda`: one launch on the current stream.  It raises
  on an input of another dtype than the net's, of another shape or not
  contiguous, and on a launch error; it allocates only its output.

``models/drl_long.py:DRLLongNet.trunk`` sends a CUDA tensor here when no
gradient is asked for (:func:`needs_grad`), and everything else to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from gym_collision_avoidance_torch.ops import build

FRAMES, CHANNELS = 3, 32

KERNEL = build.Kernel("drl_long_conv", "drl_long_conv",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2)


def out_len(L: int) -> int:
    """L2, the second convolution's output length at scan length ``L``."""
    L1 = (L - 3) // 2 + 1
    return (L1 - 1) // 2 + 1


def needs_grad(net, x) -> bool:
    """Whether the scans or the net's convolution weights ask for a
    gradient: the kernel has no backward, so such a call stays on autograd."""
    return x.requires_grad or any(
        p.requires_grad for layer in (net.conv1, net.conv2) for p in (layer.weight, layer.bias))


def drl_long_conv_plain(net, x: torch.Tensor) -> torch.Tensor:
    """``[B, 32, L2]``: ``relu(conv2(relu(conv1(x))))`` by the net's own
    ``nn.Conv1d`` layers (cuDNN on the card)."""
    return torch.relu(net.conv2(torch.relu(net.conv1(x))))


def drl_long_conv_cuda(net, x: torch.Tensor) -> torch.Tensor:
    """:func:`drl_long_conv_plain` of ``[B, 3, L]`` scans ``x`` (L >= 3) by
    one launch of the kernel on the current stream (no synchronise).
    ``net`` is a ``DRLLongNet`` on ``x``'s device."""
    dtype = net.dtype
    KERNEL.check(dtype)
    if x.dim() != 3 or x.shape[1] != FRAMES or x.shape[2] < 3:
        raise ValueError(f"x must be [B, {FRAMES}, L] with L >= 3, got {tuple(x.shape)}")
    B, _, L = x.shape
    c1, c2 = net.conv1, net.conv2
    build.check_launch_args([
        ("x", x, dtype, x.shape),
        ("conv1.weight", c1.weight, dtype, (CHANNELS, FRAMES, 5)),
        ("conv1.bias", c1.bias, dtype, (CHANNELS,)),
        ("conv2.weight", c2.weight, dtype, (CHANNELS, CHANNELS, 3)),
        ("conv2.bias", c2.bias, dtype, (CHANNELS,)),
    ], x.device)
    y = torch.empty((B, CHANNELS, out_len(L)), dtype=dtype, device=x.device)
    if B == 0:
        return y
    KERNEL(dtype, x.data_ptr(), c1.weight.data_ptr(), c1.bias.data_ptr(),
           c2.weight.data_ptr(), c2.bias.data_ptr(), y.data_ptr(), B, L, device=x.device)
    return y
