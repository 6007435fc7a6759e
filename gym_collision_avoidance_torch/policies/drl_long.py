"""DRL-Long internal policy kernel (port of
:mod:`gym_collision_avoidance_tpu.policies.drl_long`).

Wrapper semantics from ``DRLLongPolicy.find_next_action``
(envs/policies/DRLLongPolicy.py:61-119), over every agent of the batch in
one network call:

* the 3-deep laserscan history, oldest frame first, normalised
  ``scan / 6 - 0.5`` and handed to the net in float32; the quotient is a
  product with ``1 / 6`` rounded to the state's dtype, as the compiled JAX
  step computes it;
* the goal rotated into the body frame;
* ``speed`` is the reference's quirk ``vel_x * [cos(h), sin(h)]`` (only the
  x velocity as the magnitude);
* the mean action clipped to [[0, -1], [1, 1]] (generate_action_no_sampling)
  and omega turned into a heading change ``omega * dt``.

Needs ``cfg.use_static_map`` and the laserscan sensor, which fill
``state.laserscan_history``.
"""

from __future__ import annotations

import torch

from gym_collision_avoidance_torch.maps.grid import reciprocal
from gym_collision_avoidance_torch.models import drl_long as net

PARAMS_KEY = "drl_long"


def drl_long_kernel(states, cfg, params):
    """``[E, A, 2]`` (speed, delta heading) of DRL-Long for every agent."""
    if params is None or PARAMS_KEY not in params:
        raise ValueError("DRL_LONG policy requires params['drl_long'] "
                         "(models.drl_long.load_params(), init_params() or a "
                         "convert_torch_state_dict result)")
    hist = states.laserscan_history
    if hist.shape[-1] == 0:
        raise ValueError("DRL_LONG needs laserscan (cfg.use_static_map=True)")
    E, A = states.pos.shape[:2]
    dtype = states.pos.dtype
    f32 = torch.float32

    # history row 0 is newest; the net wants oldest first
    scans = (hist.flip(2) * reciprocal(6.0, dtype) - 0.5).to(f32)
    dx = states.goal[..., 0] - states.pos[..., 0]
    dy = states.goal[..., 1] - states.pos[..., 1]
    c, s = torch.cos(states.heading), torch.sin(states.heading)
    goal_local = torch.stack([dx * c + dy * s, -dx * s + dy * c], dim=-1).to(f32)
    speed = (states.vel[..., 0:1] * torch.stack([c, s], dim=-1)).to(f32)   # DRLLongPolicy.py:80

    mean = net.forward(params[PARAMS_KEY], scans.reshape(E * A, *hist.shape[2:]),
                       goal_local.reshape(E * A, 2), speed.reshape(E * A, 2))
    v = torch.clamp(mean[:, 0], 0.0, 1.0)
    w = torch.clamp(mean[:, 1], -1.0, 1.0)
    return torch.stack([v.to(dtype), (w * cfg.dt).to(dtype)], dim=-1).reshape(E, A, 2)
