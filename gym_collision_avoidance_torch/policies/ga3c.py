"""GA3C-CADRL internal policy (port of
:mod:`gym_collision_avoidance_tpu.policies.ga3c`).

``GA3CCADRLPolicy.find_next_action`` over a batch (GA3CCADRLPolicy.py:49-84):
the obs in ``STATES_IN_OBS`` order, one network call over all ``E * A``
agents, the argmax of the 11 action probabilities, speed scaled by
``pref_speed``.  The network reads the previous step's sensor output, which
the step keeps in ``state.sensed_others``.  As in the JAX kernel the obs is
built in float32 whatever the state's dtype.
"""

from __future__ import annotations

import functools

import torch

from gym_collision_avoidance_torch.models import ga3c_cadrl as net

PARAMS_KEY = "ga3c_cadrl"


@functools.lru_cache(maxsize=8)
def _actions_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The 11-action grid on the device, made once per (dtype, device)."""
    # imported here: the registry imports this module for its kernel
    from gym_collision_avoidance_torch.policies import registry

    return torch.as_tensor(registry.ga3c_actions_table(), dtype=dtype, device=device)


def ga3c_cadrl_probs(states, params):
    """The ``[E * A, 11]`` action probabilities of every agent."""
    if params is None or PARAMS_KEY not in params:
        raise ValueError("GA3C_CADRL policy requires params['ga3c_cadrl'] "
                         "(models.ga3c_cadrl.load_params())")
    p = params[PARAMS_KEY]
    E, A = states.pos.shape[:2]
    N = E * A
    K = states.sensed_others.shape[2]
    f32 = torch.float32
    scalars = torch.stack([
        states.num_other_agents_observed.to(f32),
        states.dist_to_goal.to(f32),
        states.heading_ego_frame.to(f32),
        states.pref_speed.to(f32),
        states.radius.to(f32),
    ], dim=-1).reshape(N, 5)
    if 5 + 7 * K == p.width:
        # structured route: only the A - 1 rows the LSTM can read
        T = min(K, A - 1)
        others = states.sensed_others[:, :, :T].to(f32).reshape(N, T, 7)
        probs, _value = net.forward_parts(p, scalars, others, max_seq_len=A - 1,
                                          sensor_slots=K)
    else:
        # another checkpoint width: the flat vector, cropped or zero-padded
        vec = torch.cat([scalars, states.sensed_others.to(f32).reshape(N, -1)], dim=-1)
        probs, _value = net.forward(p, vec, max_seq_len=A - 1)
    return probs


def ga3c_cadrl_kernel(states, cfg, params):
    """``[E, A, 2]`` (speed, delta heading) of GA3C-CADRL for every agent."""
    del cfg
    E, A = states.pos.shape[:2]
    idx = torch.argmax(ga3c_cadrl_probs(states, params), dim=-1)
    raw = _actions_table(states.pos.dtype, states.pos.device)[idx]
    return torch.stack([states.pref_speed.reshape(E * A) * raw[:, 0], raw[:, 1]],
                       dim=-1).reshape(E, A, 2)
