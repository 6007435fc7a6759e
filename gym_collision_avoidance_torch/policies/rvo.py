"""RVO internal policy: batched ORCA with the reference wrapper's semantics
(port of :mod:`gym_collision_avoidance_tpu.policies.rvo`).

The reference gives each RVO agent a private RVO2 simulator mirroring the
whole world and reads back only that agent's velocity
(envs/policies/RVOPolicy.py:50-122).  Every private world sees the same
snapshot and an agent's ORCA velocity depends only on its own collaboration
coefficient, so all of them are one batched ORCA call with a per-agent
coefficient.  From the wrapper:

* the preferred velocity points at the goal at ``pref_speed`` (:66-67),
* the mirrored radius is inflated by 1.05 (:71), ``maxSpeed = pref_speed``
  (:70),
* the heading follows the ORCA displacement, with a pi/6 turn limit and
  stop-and-turn beyond it (:96-111).

The JAX step multiplies by ``1 / dt`` and ``1 / rvo_anti_collab_t`` where it
is written to divide (XLA folds the constants); the port does the same, with
the reciprocals rounded to the state's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gym_collision_avoidance_torch.core import maths, prng
from gym_collision_avoidance_torch.core.device import as_device_tensor
from gym_collision_avoidance_torch.maps.grid import reciprocal
from gym_collision_avoidance_torch.ops import orca

MAX_DELTA_HEADING = math.pi / 6  # RVOPolicy.py:20

# Optional params key: ``[A]`` or ``[E, A]`` bool host-side anti-collab draws
# (True = act egoistically this window), see anti_collab_host_draws.
NONCOOP_FLAGS_KEY = "rvo_use_noncoop"


def anti_collab_host_draws(flags, t, active, cfg, rng=np.random):
    """Reference-stream-exact anti-collaborative draws of one env
    (RVOPolicy.py:77-90).

    The reference keeps a ``use_non_coop_policy`` bool per RVO agent
    (initially True) and, whenever the agent's time hits a window boundary
    (``round(t % T, 3) < DT`` or ``round(T - t % T, 3) < DT``), redraws it
    from the global numpy stream with ``np.random.choice([True, False],
    p=[1-|c|, |c|])``, in agent order, skipping done agents.

    Call on the host before each step with the agents' ``state.t`` and pass
    the result as ``params["rvo_use_noncoop"]``.

    Args:
        flags: ``[A]`` bool, the previous flags (start all True).
        t: ``[A]`` agent times at the start of the step.
        active: ``[A]`` bool, the agents that draw this step (RVO, not done,
            valid).
        rng: a numpy ``RandomState``/``Generator`` or the ``np.random``
            module (the reference's global stream).

    Returns:
        ``[A]`` bool numpy array of updated flags.
    """
    flags = np.array(flags, dtype=bool)
    T = float(cfg.rvo_anti_collab_t)
    c = abs(float(cfg.rvo_collab_coeff))
    t = np.asarray(t, dtype=float)
    for a in range(flags.shape[0]):
        if not bool(active[a]):
            continue
        rem = t[a] % T
        if round(rem, 3) < cfg.dt or round(T - rem, 3) < cfg.dt:
            flags[a] = bool(rng.choice([True, False], p=[1.0 - c, c]))
    return flags


def _collab_coeff(states, cfg, params):
    """``[E, A]`` ORCA collaboration coefficient of every agent."""
    coeff = torch.full(states.radius.shape, cfg.rvo_collab_coeff, dtype=states.pos.dtype,
                       device=states.pos.device)
    if cfg.rvo_collab_coeff >= 0:
        return coeff
    if isinstance(params, dict) and NONCOOP_FLAGS_KEY in params:
        # host-side reference-stream draws (anti_collab_host_draws)
        use_noncoop = as_device_tensor(params[NONCOOP_FLAGS_KEY], torch.bool, coeff.device)
    else:
        # Anti-collaborative mode (RVOPolicy.py:77-90): every
        # rvo_anti_collab_t seconds each agent re-chooses between egoistic
        # (coefficient 0, probability 1 - |c|) and adversarial (the raw
        # negative c).  The draw is derived per (agent, window) from the
        # env's PRNG key, as the JAX kernel derives it.  JAX's width
        # follows its x64 mode, the port's the state's dtype: equal bits for
        # a float32 state with x64 off and a float64 state with x64 on, but
        # not for a float32 state that JAX steps with x64 on.
        window = torch.floor(states.t * reciprocal(cfg.rvo_anti_collab_t, states.t.dtype))
        agent = torch.arange(states.pos.shape[1], device=coeff.device)
        keys = prng.fold_in(prng.fold_in(states.rng[:, None, :], agent),
                            window.to(torch.int32))
        use_noncoop = prng.bernoulli(keys, 1.0 - abs(cfg.rvo_collab_coeff), states.pos.dtype)
    return torch.where(use_noncoop, torch.zeros_like(coeff), coeff)


def orca_inputs(states, cfg, params):
    """The arguments of :func:`ops.orca.orca_solve` that RVOPolicy mirrors
    into its simulator: goal-directed preferred velocities, radii inflated
    by 1.05, ``maxSpeed = pref_speed``, the agents' coefficients."""
    goal_vec = states.goal - states.pos
    goal_dist = maths.norm2(goal_vec)
    pref_vel = (states.pref_speed[..., None] * goal_vec
                / torch.clamp(goal_dist, min=1e-30)[..., None])
    return (states.pos, states.vel, pref_vel, (1.0 + 5e-2) * states.radius,
            states.pref_speed, _collab_coeff(states, cfg, params), states.valid, cfg.dt,
            cfg.sensing_horizon, cfg.rvo_time_horizon)


def rvo_kernel(states, cfg, params):
    """``[E, A, 2]`` (speed, delta heading) of RVO for every agent."""
    new_vel = orca.orca_velocities(*orca_inputs(states, cfg, params))

    # displacement -> (speed, delta heading), stop-and-turn clamp
    delta_pos = new_vel * cfg.dt
    new_heading = torch.remainder(torch.atan2(delta_pos[..., 1], delta_pos[..., 0]),
                                  2 * math.pi)
    delta_heading = maths.wrap(new_heading - states.heading)
    speed = maths.norm2(delta_pos) * reciprocal(cfg.dt, states.pos.dtype)

    exceeded = torch.abs(delta_heading) > MAX_DELTA_HEADING
    delta_heading = torch.where(exceeded, torch.sign(delta_heading) * MAX_DELTA_HEADING,
                                delta_heading)
    speed = torch.where(exceeded, torch.zeros_like(speed), speed)
    return torch.stack([speed, delta_heading], dim=-1)
