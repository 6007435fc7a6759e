"""K1, the pairwise collision / nearest-gap kernel, for Hopper, and the
env step's reward stage fused into its launch.

Port of the Pallas TPU kernel ``gym_collision_avoidance_tpu/ops/pairwise.py``
(``_kernel``).  Two functions, each in three pieces:

* K1 alone, the counterpart of the JAX package's public
  ``pairwise_collisions``: :func:`pairwise_collisions_plain` (written the way
  ``env/step.py:_pairwise_collisions`` is), :func:`pairwise_collisions_cuda`
  and the wrapper :func:`pairwise_collisions`;
* the reward stage of ``env_step`` (the JAX package's
  ``env/step.py:_compute_rewards``: K1, reward shaping, the clip and the
  collision latch): :func:`pairwise_rewards_plain` (K1's plain version, then
  :func:`reward_chain_plain`), :func:`pairwise_rewards_cuda`, one launch of
  the same kernel with its reward epilogue, and the wrapper
  :func:`pairwise_rewards` that ``env/step.py:_compute_rewards`` calls.

Both launch the hand-written CUDA kernel ``csrc/pairwise.cu`` (see the note
at its top for what bounds it and its exactness rules), bitwise equal to the
plain versions on the card.  A wrapper sends a CPU tensor to the plain
version and a CUDA tensor to the kernel, or raises.  Launches of both
entries count under ``pairwise`` (``ops.launch_counts``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from gym_collision_avoidance_torch.core.maths import sqrt_rn
from gym_collision_avoidance_torch.ops import build

COLLISIONS = build.Kernel("pairwise", "pairwise_collisions",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int])
REWARDS = build.Kernel("pairwise", "pairwise_rewards",
                       [ctypes.c_void_p] * 14 + [ctypes.c_int64] + [ctypes.c_int] * 3)
_CTYPES = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


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


def reward_chain_plain(collision, nearest, valid, is_at_goal, was_at_goal_already,
                       was_in_collision_already, in_collision, past_actions, wall, cfg):
    """(reward [E, A], in_collision [E, A] bool): reward shaping, the clip
    and the collision latch from K1's outputs
    (envs/collision_avoidance_env.py:394-456), in plain PyTorch.

    Args:
        collision, nearest: K1's outputs; valid, is_at_goal,
        was_at_goal_already, was_in_collision_already, in_collision: [E, A]
        bool; past_actions: [E, A, P, 2]; wall: [E, A] bool or None (no
        static map); cfg: the env config (its reward fields).
    """
    collision_with_wall = torch.zeros_like(collision) if wall is None else wall
    r = torch.full(valid.shape, cfg.reward_time_step, dtype=nearest.dtype,
                   device=nearest.device)
    goal_now = is_at_goal & ~was_at_goal_already
    r = torch.where(goal_now, torch.full_like(r, cfg.reward_at_goal), r)

    eligible = ~is_at_goal & ~was_in_collision_already
    hit_agent = eligible & collision
    hit_wall = eligible & ~collision & collision_with_wall
    r = torch.where(hit_agent, torch.full_like(r, cfg.reward_collision_with_agent), r)
    r = torch.where(hit_wall, torch.full_like(r, cfg.reward_collision_with_wall), r)

    no_hit = eligible & ~collision & ~collision_with_wall
    close = no_hit & (nearest <= cfg.getting_close_range)
    # The -0.1 - d/2 shaping is hard-coded in the reference (":438-440").
    r = torch.where(close, cfg.reward_getting_close - nearest / 2.0, r)
    wiggly = no_hit & (torch.abs(past_actions[..., 0, 1]) > cfg.wiggly_behavior_threshold)
    r = torch.where(wiggly, r + cfg.reward_wiggly_behavior, r)

    # Clip to the min/max possible single-step reward (":451-453, 589-599").
    lo, hi = _clip_range(cfg)
    r = torch.clamp(r, lo, hi)
    r = torch.where(valid, r, torch.zeros_like(r))
    return r, in_collision | hit_agent | hit_wall


def _clip_range(cfg):
    possible = [
        cfg.reward_at_goal,
        cfg.reward_collision_with_agent,
        cfg.reward_time_step,
        cfg.reward_collision_with_wall,
        cfg.reward_wiggly_behavior,
    ]
    return min(possible), max(possible)


def reward_constants(cfg):
    """The reward epilogue's constants, as Python floats in the kernel's
    order (``csrc/pairwise.cu``, ``kTimeStep`` .. ``kClipHi``)."""
    return (cfg.reward_time_step, cfg.reward_at_goal, cfg.reward_collision_with_agent,
            cfg.reward_collision_with_wall, cfg.reward_getting_close,
            cfg.getting_close_range, cfg.reward_wiggly_behavior,
            cfg.wiggly_behavior_threshold, *_clip_range(cfg))


def pairwise_rewards_plain(pos, radius, valid, is_at_goal, was_at_goal_already,
                           was_in_collision_already, in_collision, past_actions, wall, cfg):
    """(collision, nearest_gap, reward, in_collision): the reward stage of
    an env step in plain PyTorch, K1's plain version and then
    :func:`reward_chain_plain`.  ``in_collision`` is a new tensor."""
    collision, nearest = pairwise_collisions_plain(pos, radius, valid)
    reward, latched = reward_chain_plain(collision, nearest, valid, is_at_goal,
                                         was_at_goal_already, was_in_collision_already,
                                         in_collision, past_actions, wall, cfg)
    return collision, nearest, reward, latched


def lanes_for(num_agents):
    """Threads that share one (env, i) row in the kernel: the largest power
    of two <= A / 4 (at least 1, at most 32), so that each thread takes
    about four partners.  One thread a row leaves a long serial chain at
    A = 20 or 40; more lanes add threads whose fixed cost outweighs it
    (``chip_smoke.py``'s layout sweep, PERF.md section 6)."""
    lanes = 1
    while lanes * 2 <= min(num_agents // 4, 32):
        lanes *= 2
    return lanes


def _lanes(lanes, A):
    if lanes == 0:
        return lanes_for(A)
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes must be 0 (lanes_for's choice) or a power of two "
                         f"up to 32, got {lanes}")
    return lanes


def pairwise_collisions_cuda(pos, radius, valid, lanes=0):
    """Launch the CUDA kernel on the current stream (no synchronise).
    ``lanes`` threads share a row (0: :func:`lanes_for`'s choice; 1 is one
    thread a row)."""
    if pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"pos must be [E, A, 2], got {tuple(pos.shape)}")
    E, A = pos.shape[:2]
    lanes = _lanes(lanes, A)
    COLLISIONS.check(pos.dtype)
    build.check_launch_args([("pos", pos, pos.dtype, (E, A, 2)),
                             ("radius", radius, pos.dtype, (E, A)),
                             ("valid", valid, torch.bool, (E, A))], pos.device)
    collision = torch.empty((E, A), dtype=torch.bool, device=pos.device)
    nearest = torch.empty((E, A), dtype=pos.dtype, device=pos.device)
    COLLISIONS(pos.dtype, pos.data_ptr(), radius.data_ptr(), valid.data_ptr(),
               collision.data_ptr(), nearest.data_ptr(), E, A, lanes, device=pos.device)
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


def pairwise_rewards_cuda(pos, radius, valid, is_at_goal, was_at_goal_already,
                          was_in_collision_already, in_collision, past_actions, wall, cfg,
                          lanes=0):
    """Launch the kernel with its reward epilogue on the current stream (no
    synchronise).  ``past_actions`` is read in place: it must be the
    contiguous ``[E, A, P, 2]`` leaf.  ``lanes`` as for
    :func:`pairwise_collisions_cuda`."""
    if pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"pos must be [E, A, 2], got {tuple(pos.shape)}")
    E, A = pos.shape[:2]
    lanes = _lanes(lanes, A)
    REWARDS.check(pos.dtype)
    if past_actions.dim() != 4 or past_actions.shape[2] < 1:
        raise ValueError(f"past_actions must be [E, A, P, 2], got {tuple(past_actions.shape)}")
    P = past_actions.shape[2]
    fields = [("pos", pos, pos.dtype, (E, A, 2)), ("radius", radius, pos.dtype, (E, A)),
              ("past_actions", past_actions, pos.dtype, (E, A, P, 2))]
    masks = [("valid", valid), ("is_at_goal", is_at_goal),
             ("was_at_goal_already", was_at_goal_already),
             ("was_in_collision_already", was_in_collision_already),
             ("in_collision", in_collision)] + ([] if wall is None else [("wall", wall)])
    fields += [(name, t, torch.bool, (E, A)) for name, t in masks]
    build.check_launch_args(fields, pos.device)
    values = reward_constants(cfg)
    consts = (_CTYPES[pos.dtype] * len(values))(*values)   # rounded to the state's dtype
    collision = torch.empty((E, A), dtype=torch.bool, device=pos.device)
    nearest = torch.empty((E, A), dtype=pos.dtype, device=pos.device)
    reward = torch.empty((E, A), dtype=pos.dtype, device=pos.device)
    latched = torch.empty((E, A), dtype=torch.bool, device=pos.device)
    REWARDS(pos.dtype, pos.data_ptr(), radius.data_ptr(), valid.data_ptr(),
            is_at_goal.data_ptr(), was_at_goal_already.data_ptr(),
            was_in_collision_already.data_ptr(), in_collision.data_ptr(),
            past_actions.data_ptr(), None if wall is None else wall.data_ptr(),
            ctypes.addressof(consts), collision.data_ptr(), nearest.data_ptr(),
            reward.data_ptr(), latched.data_ptr(), E, A, P, lanes, device=pos.device)
    return collision, nearest, reward, latched


def pairwise_rewards(pos, radius, valid, is_at_goal, was_at_goal_already,
                     was_in_collision_already, in_collision, past_actions, wall, cfg):
    """(collision [E, A] bool, nearest_gap [E, A], reward [E, A],
    in_collision [E, A] bool): the reward stage of an env step for an env
    batch (see :func:`pairwise_rewards_plain` for the arguments).

    CPU tensors -> plain version; CUDA tensors -> one launch of the kernel.
    """
    args = (pos, radius, valid, is_at_goal, was_at_goal_already,
            was_in_collision_already, in_collision, past_actions, wall, cfg)
    if pos.device.type == "cpu":
        return pairwise_rewards_plain(*args)
    if pos.device.type == "cuda":
        return pairwise_rewards_cuda(*args)
    raise ValueError(f"no pairwise_rewards for device {pos.device}")
