"""Plain reference of the DRL-Long policy (Long et al., "Towards Optimally
Decentralized Multi-Robot Collision Avoidance via Deep Reinforcement
Learning", ICRA 2018, arXiv:1709.10082; upstream
``envs/policies/DRLLongPolicy.py:61-119``), in float32, read from the
``.npz`` checkpoint.

The net: three frames of the laser scan, oldest first, ``[B, 3, L]`` ->
Conv1d(3->32, k5, s2, p1) + ReLU -> Conv1d(32->32, k3, s2, p1) + ReLU ->
flatten -> Dense(256) + ReLU; that, the goal and the speed ``[B, 260]`` ->
Dense(128) + ReLU -> the mean action ``[sigmoid(v), tanh(w)]``.  The wrapper
(``find_next_action``): the scan history (newest first in the state) flipped
to oldest first, times ``1/6`` rounded to the state's dtype, minus 0.5; the
goal rotated into the body frame; the speed by upstream's quirk ``vel_x *
[cos h, sin h]`` (only the x velocity as the magnitude); the mean clipped to
``[[0, -1], [1, 1]]`` and ``w`` turned into a heading change ``w * dt``.

Departures from the paper: the weights are the repository's own
``drl_long_2agent_rvo_tpu.npz`` (the upstream repository ships the DRL-Long
submodule empty), trained against RVO agents with two agents an env; the
action is the mean, not a sample of the paper's Gaussian; its critic head and
log-std are not read.  The products run under the judge's TF32-off flags.

The action is continuous, so no agent's action is an argmax (``ranked`` is
false everywhere); a rounding difference parts an env only where the step
turns it into another branch, which :func:`margins` measures
(:func:`perfbench.reference.sim.step_margins`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import sim

FRAMES = 3
# the checkpoint's scan length: fc1 reads 32 channels x 128 = 4096
LASERSCAN_LENGTH = 512
NAMES = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
         "actor1_w", "actor1_b", "actor2_w", "actor2_b")


def conv_out(length: int, kernel: int, stride: int, pad: int) -> int:
    return (length + 2 * pad - kernel) // stride + 1


def load(path: str, device) -> dict:
    """The actor's leaves, dense kernels as ``[out, in]`` (the checkpoint
    holds them ``[in, out]``)."""
    with np.load(path) as z:
        w = {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device) for k in NAMES}
    for k in ("fc1_w", "fc2_w", "actor1_w", "actor2_w"):
        w[k] = w[k].T.contiguous()
    return w


def flops(rows: int, num_agents: int) -> float:
    """One forward over ``rows`` agents at the checkpoint's scan length (a
    multiply-add two operations; biases and activations left out): conv1
    3 x 5 -> 32 at 255 outputs, conv2 32 x 3 -> 32 at 128, 4096 -> 256,
    260 -> 128 and the two heads 128 -> 1; 3 195 456 a row."""
    del num_agents
    l1 = conv_out(LASERSCAN_LENGTH, 5, 2, 1)
    l2 = conv_out(l1, 3, 2, 1)
    per_row = (FRAMES * 5 * 32 * l1 + 32 * 3 * 32 * l2 + 32 * l2 * 256 + (256 + 4) * 128
               + 128 * 2)
    return 2.0 * rows * per_row


def output_error(program, reference):
    """The mean action's error, absolute (v lies in [0, 1], w in [-1, 1])."""
    return (program - reference).abs()


def net(w: dict, scans, goal, speed):
    """The mean action ``[B, 2]`` of ``[B, 3, L]`` normalised scans (oldest
    first) and ``[B, 2]`` body-frame goals and speeds."""
    h = torch.relu(F.conv1d(scans, w["conv1_w"], w["conv1_b"], stride=2, padding=1))
    h = torch.relu(F.conv1d(h, w["conv2_w"], w["conv2_b"], stride=2, padding=1))
    h = torch.relu(F.linear(h.reshape(h.shape[0], -1), w["fc1_w"], w["fc1_b"]))
    z = torch.relu(F.linear(torch.cat([h, goal, speed], dim=-1), w["fc2_w"], w["fc2_b"]))
    return torch.cat([torch.sigmoid(F.linear(z, w["actor1_w"], w["actor1_b"])),
                      torch.tanh(F.linear(z, w["actor2_w"], w["actor2_b"]))], dim=-1)


def decide(w: dict, s: dict, cfg):
    """``(actions [E, A, 2], scores [E, A, 2], mean [E * A, 2], ranked
    [E, A])``: every agent's clipped action, the net's mean action as its
    scores and as the outputs the program's ``models.drl_long:forward``
    returns, and no agent ranked."""
    hist = s["laserscan_history"]
    if hist.shape[-1] != LASERSCAN_LENGTH:
        raise ValueError(f"the checkpoint reads {LASERSCAN_LENGTH}-beam scans, not "
                         f"{hist.shape[-1]}")
    E, A = s["pos"].shape[:2]
    dtype, f32 = s["pos"].dtype, torch.float32
    scans = (hist.flip(2) * sim.reciprocal(6.0, dtype) - 0.5).to(f32)
    dx = s["goal"][..., 0] - s["pos"][..., 0]
    dy = s["goal"][..., 1] - s["pos"][..., 1]
    c, sn = torch.cos(s["heading"]), torch.sin(s["heading"])
    goal = torch.stack([dx * c + dy * sn, -dx * sn + dy * c], dim=-1).to(f32)
    speed = (s["vel"][..., 0:1] * torch.stack([c, sn], dim=-1)).to(f32)
    mean = net(w, scans.reshape(E * A, FRAMES, -1), goal.reshape(E * A, 2),
               speed.reshape(E * A, 2))
    v = torch.clamp(mean[:, 0], 0.0, 1.0)
    turn = torch.clamp(mean[:, 1], -1.0, 1.0)
    act = torch.stack([v.to(dtype), (turn * cfg.dt).to(dtype)], dim=-1).reshape(E, A, 2)
    return (act, mean.reshape(E, A, 2), mean,
            torch.zeros((E, A), dtype=torch.bool, device=mean.device))


# each env's distance to a branch of one step: the step's own, since the
# policy has none
margins = sim.step_margins
