"""The env state: a dataclass of ``[E, A, ...]`` tensors.

Port of :mod:`gym_collision_avoidance_tpu.core.state`.  The JAX state holds
one env (``[A, ...]`` leaves) and is vmapped; here every leaf carries the
env axis E in front, and ``episode_step`` is ``[E]``.  ``rng`` is an
``[E, 2]`` int64 tensor holding the words of the JAX PRNG key; the policies
of this package never consume it, so it is only carried across resets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core import dynamics as dyn
from gym_collision_avoidance_torch.core import maths
from gym_collision_avoidance_torch.core.device import (as_device_tensor, resolve_device,
                                                        torch_dtype)

# Number of past actions / velocities remembered per agent
# (reference: envs/agent.py:38 `num_actions_to_store = 2`).
NUM_PAST_ACTIONS = 2

@dataclasses.dataclass
class EnvState:
    """All mutable simulation state for a batch of E envs.

    Field names and meanings are those of the JAX ``EnvState``
    (envs/agent.py:59-139 provenance there); shapes gain a leading E.
    """

    pos: torch.Tensor            # [E, A, 2]
    vel: torch.Tensor            # [E, A, 2]
    speed: torch.Tensor          # [E, A]
    heading: torch.Tensor        # [E, A]
    delta_heading: torch.Tensor  # [E, A]
    goal: torch.Tensor           # [E, A, 2]
    radius: torch.Tensor         # [E, A]
    pref_speed: torch.Tensor     # [E, A]
    ref_prll: torch.Tensor       # [E, A, 2]
    ref_orth: torch.Tensor       # [E, A, 2]
    dist_to_goal: torch.Tensor   # [E, A]
    heading_ego_frame: torch.Tensor  # [E, A]
    vel_ego_frame: torch.Tensor  # [E, A, 2]
    past_actions: torch.Tensor   # [E, A, NUM_PAST_ACTIONS, 2]
    past_vel: torch.Tensor       # [E, A, NUM_PAST_ACTIONS, 2]
    turning_dir: torch.Tensor    # [E, A]
    time_remaining: torch.Tensor  # [E, A]
    t: torch.Tensor              # [E, A]
    step_num: torch.Tensor       # [E, A] int32
    is_at_goal: torch.Tensor     # [E, A] bool
    was_at_goal_already: torch.Tensor  # [E, A] bool
    in_collision: torch.Tensor   # [E, A] bool
    was_in_collision_already: torch.Tensor  # [E, A] bool
    ran_out_of_time: torch.Tensor  # [E, A] bool
    is_done: torch.Tensor        # [E, A] bool
    other_agent_states: torch.Tensor  # [E, A, 7]
    sensed_others: torch.Tensor  # [E, A, K, 7]
    num_other_agents_observed: torch.Tensor  # [E, A] int32
    laserscan_history: torch.Tensor  # [E, A, P, L] with a static map, else [E, A, 0, 0]
    laserscan_count: torch.Tensor    # [E, A] int32
    policy_id: torch.Tensor      # [E, A] int32
    dynamics_id: torch.Tensor    # [E, A] int32
    valid: torch.Tensor          # [E, A] bool
    episode_step: torch.Tensor   # [E] int32
    rng: torch.Tensor            # [E, 2] int64

    @property
    def num_agents(self) -> int:
        return self.pos.shape[-2]

    @property
    def num_envs(self) -> int:
        return self.pos.shape[0]

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    def items(self):
        return ((f.name, getattr(self, f.name)) for f in dataclasses.fields(self))

    def map(self, fn, *others) -> "EnvState":
        """A new state whose every leaf is ``fn(leaf, *other_leaves)``."""
        return EnvState(**{
            name: fn(leaf, *(getattr(o, name) for o in others))
            for name, leaf in self.items()
        })

    def to(self, device) -> "EnvState":
        return self.map(lambda x: x.to(device))


def init_state(
    cfg: EnvConfig,
    pos,
    goal,
    radius,
    pref_speed,
    heading=None,
    policy_id=None,
    dynamics_id=None,
    valid=None,
    rng=None,
    device=None,
) -> EnvState:
    """Freshly-reset states for a batch of envs (``Agent.reset``,
    envs/agent.py:59-139, then ``update_ego_frame``).

    Args: ``pos``/``goal`` ``[E, A, 2]``; ``radius``, ``pref_speed``,
    ``heading``, ``policy_id``, ``dynamics_id``, ``valid`` ``[E, A]``;
    ``rng`` ``[E, 2]`` key words (default zeros, the JAX ``PRNGKey(0)``).
    NaN headings point at the goal (envs/agent.py:79-83).
    ``device=None`` means CUDA.
    """
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def as_t(x, dt):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dt, device=device)

    pos = as_t(pos, dtype)
    goal = as_t(goal, dtype)
    radius = as_t(radius, dtype)
    pref_speed = as_t(pref_speed, dtype)
    E, A = pos.shape[:2]

    vec_to_goal = goal - pos
    auto_heading = maths.arctan2(
        vec_to_goal[..., 1], vec_to_goal[..., 0], exact=cfg.strict_parity
    )
    if heading is None:
        heading = auto_heading
    else:
        heading = as_t(heading, dtype).expand(E, A)
        heading = torch.where(torch.isnan(heading), auto_heading, heading)

    vel = torch.zeros((E, A, 2), dtype=dtype, device=device)

    # Timeout budget (envs/agent.py:100-105).
    straight_line_time = (maths.norm2(vec_to_goal) - cfg.near_goal_threshold) / pref_speed
    time_remaining = torch.clamp(cfg.max_time_ratio * straight_line_time, min=cfg.dt)

    ref_prll, ref_orth, dist_to_goal, heading_ego, vel_ego = dyn.update_ego_frame(
        pos, goal, heading, vel, exact=cfg.strict_parity
    )

    def ids(x, default):
        if x is None:
            return torch.full((E, A), default, dtype=torch.int32, device=device)
        return as_t(x, torch.int32).expand(E, A).contiguous()

    # Default policy is NonCooperative (id 2), as in the JAX package.
    policy_id = ids(policy_id, 2)
    dynamics_id = ids(dynamics_id, dyn.UNICYCLE)
    if valid is None:
        valid = torch.ones((E, A), dtype=torch.bool, device=device)
    else:
        valid = as_t(valid, torch.bool).expand(E, A).contiguous()
    if rng is None:
        rng = torch.zeros((E, 2), dtype=torch.int64, device=device)
    else:
        rng = as_t(rng, torch.int64).expand(E, 2).contiguous()

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    K = cfg.max_num_other_agents_observed
    return EnvState(
        pos=pos,
        vel=vel,
        speed=zeros(E, A),
        heading=heading.contiguous(),
        delta_heading=zeros(E, A),
        goal=goal,
        radius=radius,
        pref_speed=pref_speed,
        ref_prll=ref_prll,
        ref_orth=ref_orth,
        dist_to_goal=dist_to_goal,
        heading_ego_frame=heading_ego,
        vel_ego_frame=vel_ego,
        past_actions=zeros(E, A, NUM_PAST_ACTIONS, 2),
        past_vel=zeros(E, A, NUM_PAST_ACTIONS, 2),
        turning_dir=zeros(E, A),
        time_remaining=time_remaining,
        t=zeros(E, A),
        step_num=zeros(E, A, dt=torch.int32),
        is_at_goal=zeros(E, A, dt=torch.bool),
        was_at_goal_already=zeros(E, A, dt=torch.bool),
        in_collision=zeros(E, A, dt=torch.bool),
        was_in_collision_already=zeros(E, A, dt=torch.bool),
        ran_out_of_time=zeros(E, A, dt=torch.bool),
        is_done=~valid,
        other_agent_states=zeros(E, A, 7),
        sensed_others=zeros(E, A, K, 7),
        num_other_agents_observed=zeros(E, A, dt=torch.int32),
        laserscan_history=(zeros(E, A, cfg.laserscan_num_past, cfg.laserscan_length)
                           if cfg.use_static_map else zeros(E, A, 0, 0)),
        laserscan_count=zeros(E, A, dt=torch.int32),
        policy_id=policy_id,
        dynamics_id=dynamics_id,
        valid=valid,
        episode_step=zeros(E, dt=torch.int32),
        rng=rng,
    )


def apply_external_states(state: EnvState, cfg: EnvConfig, pos, vel=None, heading=None,
                          mask=None) -> EnvState:
    """Inject externally measured states (a real robot, a simulator), as
    ``Agent.set_state`` does (envs/agent.py:155-190): a missing velocity is
    the position change over ``cfg.dt`` (zero at ``step_num`` 0), a missing
    heading the velocity's direction; the heading change is wrapped.

    Args:
        pos: ``[E, A, 2]`` positions; ``vel`` ``[E, A, 2]`` and ``heading``
            ``[E, A]`` optional.
        mask: ``[E, A]`` bool, the agents to update (default: the agents
            with EXTERNAL dynamics).

    The JAX function has no jitted caller, so its quotient by ``dt`` is a
    true division; the port divides by a 0-dim tensor, which CUDA does not
    rewrite as a product with the reciprocal.
    """
    dtype, device = state.pos.dtype, state.pos.device
    pos = as_device_tensor(pos, dtype, device).expand_as(state.pos)
    if mask is None:
        mask = state.dynamics_id == dyn.EXTERNAL
    else:
        mask = as_device_tensor(mask, torch.bool, device).expand(state.pos.shape[:-1])
    if vel is None:
        interp = (pos - state.pos) / torch.tensor(cfg.dt, dtype=dtype, device=device)
        vel = torch.where((state.step_num == 0)[..., None], torch.zeros_like(interp), interp)
    else:
        vel = as_device_tensor(vel, dtype, device).expand_as(state.vel)
    if heading is None:
        heading = torch.atan2(vel[..., 1], vel[..., 0])
    else:
        heading = as_device_tensor(heading, dtype, device).expand_as(state.heading)
    delta_heading = maths.wrap(heading - state.heading)
    speed = maths.norm2(vel)

    def sel(new, old):
        return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - mask.dim())), new, old)

    return state.replace(
        pos=sel(pos, state.pos),
        vel=sel(vel, state.vel),
        speed=sel(speed, state.speed),
        heading=sel(heading, state.heading),
        delta_heading=sel(delta_heading, state.delta_heading),
    )
