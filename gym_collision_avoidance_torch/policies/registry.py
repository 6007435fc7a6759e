"""Policy ids and batched action dispatch (port of
:mod:`gym_collision_avoidance_tpu.policies.registry`).

Every internal policy is a kernel ``(state, cfg, params) -> [E, A, 2]`` over
the whole batch; the per-agent choice is a masked select on ``policy_id``.
Every policy of the JAX package is ported: NonCoop, Static, the external
mappers, GA3C-CADRL (``policies/ga3c.py``), SA-CADRL (``policies/cadrl.py``),
RVO (``policies/rvo.py``) and DRL-Long (``policies/drl_long.py``).  SARL
(``policies/sarl.py``) is the port's own: the JAX package has no such
policy.
"""

from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch

from gym_collision_avoidance_torch.policies import cadrl, drl_long, ga3c, rvo, sarl

# -- policy type ids (state.policy_id values), as in the JAX package --------
EXTERNAL = 0       # envs/policies/ExternalPolicy.py (identity passthrough)
STATIC = 1         # envs/policies/StaticPolicy.py
NONCOOP = 2        # envs/policies/NonCooperativePolicy.py
LEARNING = 3       # envs/policies/LearningPolicy.py (external, continuous)
LEARNING_GA3C = 4  # envs/policies/LearningPolicyGA3C.py (external, discrete)
CARRL = 5          # envs/policies/CARRLPolicy.py (external, discrete)
GA3C_CADRL = 6     # envs/policies/GA3CCADRLPolicy.py (internal NN)
CADRL = 7          # envs/policies/CADRLPolicy.py (internal NN + lookahead)
RVO = 8            # envs/policies/RVOPolicy.py (internal ORCA)
DRL_LONG = 9       # policies/drl_long.py of the JAX package (internal CNN)
SARL = 10          # policies/sarl.py (internal attention value net + lookahead)

POLICY_NAMES: Mapping[str, int] = {
    "external": EXTERNAL,
    "static": STATIC,
    "noncoop": NONCOOP,
    "learning": LEARNING,
    "learning_ga3c": LEARNING_GA3C,
    "carrl": CARRL,
    "GA3C_CADRL": GA3C_CADRL,
    "CADRL": CADRL,
    "RVO": RVO,
    "drllong": DRL_LONG,
    "SARL": SARL,
}

# Policies that receive their action from the caller of env_step.
EXTERNAL_POLICIES = (EXTERNAL, LEARNING, LEARNING_GA3C, CARRL)
# Policies whose obs field is_learning == 1.
LEARNING_POLICIES = (LEARNING, LEARNING_GA3C)
# Policies with is_still_learning=True (the "learning" done mode).
STILL_LEARNING_POLICIES = (LEARNING, LEARNING_GA3C)


def ga3c_actions_table(dtype=np.float64) -> np.ndarray:
    """The 11-entry discrete action grid of GA3C-CADRL
    (envs/policies/GA3C_CADRL/network.py:7-16)."""
    a = np.mgrid[1.0:1.1:0.5, -np.pi / 6:np.pi / 6 + 0.01:np.pi / 12].reshape(2, -1).T
    a = np.vstack([a, np.mgrid[0.5:0.6:0.5, -np.pi / 6:np.pi / 6 + 0.01:np.pi / 6].reshape(2, -1).T])
    a = np.vstack([a, np.mgrid[0.0:0.1:0.5, -np.pi / 6:np.pi / 6 + 0.01:np.pi / 6].reshape(2, -1).T])
    return a.astype(dtype)


def carrl_actions_table(dtype=np.float64) -> np.ndarray:
    """11 actions, speed 1, heading in linspace(-pi/6, pi/6, 11)
    (envs/policies/CARRLPolicy.py:13-18)."""
    a = np.zeros((11, 2), dtype=dtype)
    a[:, 0] = 1.0
    a[:, 1] = np.linspace(-np.pi / 6, np.pi / 6, 11)
    return a


@functools.lru_cache(maxsize=8)
def _carrl_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`carrl_actions_table` on the device, made once per (dtype, device)."""
    return torch.as_tensor(carrl_actions_table(), dtype=dtype, device=device)


def noncoop_kernel(state, cfg, params):
    """Straight to goal at pref speed (NonCooperativePolicy.py:21)."""
    del cfg, params
    return torch.stack([state.pref_speed, -state.heading_ego_frame], dim=-1)


def static_kernel(state, cfg, params):
    """Zero action (StaticPolicy.py:21-22); the goal pin is applied by the
    step function."""
    del cfg, params
    return torch.zeros_like(state.pos)


INTERNAL_KERNELS = {
    STATIC: static_kernel,
    NONCOOP: noncoop_kernel,
    GA3C_CADRL: ga3c.ga3c_cadrl_kernel,
    CADRL: cadrl.cadrl_kernel,
    RVO: rvo.rvo_kernel,
    DRL_LONG: drl_long.drl_long_kernel,
    SARL: sarl.sarl_kernel,
}


def internal_kernel(pid: int):
    """The kernel of internal policy ``pid``."""
    kernel = INTERNAL_KERNELS.get(pid)
    if kernel is None:
        raise NotImplementedError(f"internal policy id {pid} has no kernel")
    return kernel


def map_external_actions(state, ext_actions, cfg):
    """Caller-provided ``[E, A, 2]`` external actions -> (speed,
    delta-heading), per policy id (LearningPolicy.py:31-33,
    LearningPolicyGA3C.py:25-27, CARRLPolicy.py:31).  For the discrete
    policies the action index is ``ext_actions[..., 0]`` cast to int."""
    dtype = state.pos.dtype
    pid = state.policy_id
    ext = torch.as_tensor(ext_actions, dtype=dtype, device=state.pos.device)

    out = ext  # EXTERNAL identity default
    learn = torch.stack(
        [state.pref_speed * ext[..., 0],
         cfg.max_heading_change * (2.0 * ext[..., 1] - 1.0)],
        dim=-1,
    )
    out = torch.where((pid == LEARNING)[..., None], learn, out)

    idx = torch.clamp(ext[..., 0].to(torch.int32), 0, 10).long()
    grid = ga3c._actions_table(dtype, ext.device)[idx]
    grid = torch.stack([grid[..., 0] * state.pref_speed, grid[..., 1]], dim=-1)
    out = torch.where((pid == LEARNING_GA3C)[..., None], grid, out)

    carrl = _carrl_table(dtype, ext.device)[idx]
    return torch.where((pid == CARRL)[..., None], carrl, out)


def compute_actions(state, ext_actions, cfg, params, active_policies):
    """The ``[E, A, 2]`` actions of every agent
    (envs/collision_avoidance_env.py:309-323): external agents get their
    mapped action, internal agents their kernel's, done agents zero."""
    actions = torch.zeros_like(state.pos)

    external = [p for p in active_policies if p in EXTERNAL_POLICIES]
    if external:
        if ext_actions is None:
            raise ValueError("scenario contains external policies but no actions given")
        mapped = map_external_actions(state, ext_actions, cfg)
        actions = torch.where(_isin(state.policy_id, external)[..., None], mapped, actions)

    for pid in active_policies:
        if pid in EXTERNAL_POLICIES:
            continue
        actions = torch.where((state.policy_id == pid)[..., None],
                              internal_kernel(pid)(state, cfg, params), actions)

    # Done agents contribute a zero action (collision_avoidance_env.py:311-312).
    return torch.where(state.is_done[..., None], torch.zeros_like(actions), actions)


def _isin(arr, values):
    mask = torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)
    for v in values:
        mask = mask | (arr == v)
    return mask
