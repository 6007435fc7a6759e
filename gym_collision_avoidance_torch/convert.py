"""State carried across from the JAX package, as numpy arrays.

The "parameters" of the main path are its state and its scenario pool
(NonCoop has no weights).  :func:`state_from_numpy` builds the port's
:class:`EnvState` from the leaves of a batched JAX ``EnvState`` (the caller
runs ``jax.device_get``, so this package never imports jax), and
:func:`state_to_numpy` converts back for comparison.  Every leaf goes both
ways, the laser ones included (``laserscan_history`` ``[E, A, P, L]`` in
the state's dtype, ``laserscan_count`` int32); the static map and its cell
list are numpy arrays both packages take as they are.
:func:`ga3c_params_from_numpy`, :func:`cadrl_params_from_numpy` and
:func:`drl_long_params_from_numpy` build the port's GA3C-CADRL, SA-CADRL and
DRL-Long modules from the JAX package's parameter dicts, so both packages run
the same weights.  :func:`ppo_params_from_numpy`, :func:`ppo_params_to_numpy`
and :func:`adam_state_from_numpy` carry the PPO trainer's nets and optimizer
state across in the JAX package's names and layouts, so a JAX
``--export-params`` file warm-starts the port and the port's export loads in
the JAX package's ``models.ga3c_cadrl.load_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.core.state import EnvState
from gym_collision_avoidance_torch.models.cadrl import CADRLValueNet
from gym_collision_avoidance_torch.models.drl_long import DRLLongNet, is_dense_weight
from gym_collision_avoidance_torch.models.ga3c_cadrl import GA3CCADRL

_INT_LEAVES = ("step_num", "num_other_agents_observed", "laserscan_count",
               "policy_id", "dynamics_id", "episode_step")


def state_from_numpy(leaves: Dict[str, np.ndarray], device=None) -> EnvState:
    """An :class:`EnvState` from ``{field name: [E, A, ...] array}``.

    Floats keep their dtype, counters and ids become int32, flags bool and
    the ``[E, 2]`` uint32 PRNG key words int64.  ``device=None`` means CUDA.
    """
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(EnvState):
        arr = np.asarray(leaves[f.name])
        if f.name == "rng":
            arr = arr.astype(np.int64)
        elif f.name in _INT_LEAVES:
            arr = arr.astype(np.int32)
        out[f.name] = torch.as_tensor(np.array(arr, copy=True), device=device)
    return EnvState(**out)


def state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """``{field name: numpy array}`` of a state, on the host."""
    return {name: leaf.detach().cpu().numpy() for name, leaf in state.items()}


def ga3c_params_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> GA3CCADRL:
    """The port's :class:`GA3CCADRL` from the JAX package's GA3C-CADRL
    parameter dict as numpy arrays (``jax.device_get(load_params(...))``).
    The weights keep their dtype (float32, float64 or bfloat16) and the
    normalisation constants stay float32.  ``device=None`` means CUDA."""
    return GA3CCADRL(arrays).to(resolve_device(device))


def cadrl_params_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> CADRLValueNet:
    """The port's :class:`CADRLValueNet` from the JAX package's SA-CADRL
    parameter dict as numpy arrays (``jax.device_get(load_params(...))``,
    unpadded), in its dtype.  ``device=None`` means CUDA."""
    return CADRLValueNet(arrays).to(resolve_device(device))


def drl_long_params_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> DRLLongNet:
    """The port's :class:`DRLLongNet` from the JAX package's DRL-Long
    parameter dict as numpy arrays (``init_params``,
    ``init_actor_critic_params`` or a loaded checkpoint), in its dtype.
    ``device=None`` means CUDA."""
    return DRLLongNet(arrays).to(resolve_device(device))


def _jax_layout(arch: str, name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.array(a.T if arch == "drl_long" and is_dense_weight(name) else a)


def _port_layout(arch: str, name: str, a, like: torch.Tensor) -> torch.Tensor:
    a = np.asarray(a)
    if arch == "drl_long" and is_dense_weight(name):
        a = a.T
    return torch.as_tensor(np.array(a, copy=True), dtype=like.dtype, device=like.device)


def ppo_params_from_numpy(arch: str, arrays: Dict[str, np.ndarray], device=None):
    """The PPO trainer's trainable net for ``arch`` (``mlp``, ``ga3c`` or
    ``drl_long``) from the JAX package's parameter dict as numpy arrays
    (``jax.device_get(params)`` or an ``--export-params`` file), in its
    dtype.  ``device=None`` means CUDA."""
    device = resolve_device(device)
    if arch == "mlp":
        from gym_collision_avoidance_torch.train.ppo import ActorCritic

        return ActorCritic(arrays).to(device)
    if arch == "ga3c":
        return GA3CCADRL(arrays, trainable=True).to(device)
    if arch == "drl_long":
        return DRLLongNet(arrays).to(device).requires_grad_(True)
    raise ValueError(f"unknown policy_arch {arch!r}")


def ppo_params_to_numpy(arch: str, params) -> Dict[str, np.ndarray]:
    """``{name: array}`` of a PPO net in the JAX package's names and layout
    (DRL-Long's dense kernels ``[in, out]``)."""
    from gym_collision_avoidance_torch.train.ppo import trainable_params

    return {k: _jax_layout(arch, k, t) for k, t in trainable_params(params).items()}


def adam_state_from_numpy(arch: str, opt_state, params):
    """The port's optimizer state from optax's ``chain(clip_by_global_norm,
    adam)`` state as numpy arrays (``jax.device_get(opt_state)``): the
    ``ScaleByAdamState(count, mu, nu)`` found in the nested tuples, its
    moments laid out as ``params``' tensors (on their device) and the count
    on the host."""
    from gym_collision_avoidance_torch.train.ppo import trainable_params

    def find(node):
        if getattr(node, "_fields", None) == ("count", "mu", "nu"):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                found = find(child)
                if found is not None:
                    return found
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState(count, mu, nu) in the optimizer state")
    named = trainable_params(params)
    return {"count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
            "mu": {k: _port_layout(arch, k, adam.mu[k], p) for k, p in named.items()},
            "nu": {k: _port_layout(arch, k, adam.nu[k], p) for k, p in named.items()}}
