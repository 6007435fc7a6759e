"""The env-axis mesh (port of :mod:`gym_collision_avoidance_tpu.parallel.mesh`).

The JAX package shards the ``[E, ...]`` env batch over a 1-D ``("env",)``
``jax.sharding.Mesh``.  Here the mesh is a set of ``torch.distributed``
ranks, one process and one device each: rank ``r`` of ``D`` owns the
contiguous env rows ``[r * E/D, (r + 1) * E/D)``, the layout of the JAX
package's ``process_env_slice``.  Steps are embarrassingly parallel; the
only collectives are metric reductions (and, in training, the advantage
statistics and gradients: ``train/ppo.py:make_sharded_ppo``).

:class:`EnvMesh` is a thin class around a process group, not a
``torch.distributed.device_mesh.DeviceMesh``: a ``DeviceMesh`` over
``"cuda"`` picks the device of a rank and the default backend (NCCL) by
itself, while a one-card check must run two ranks on one card over gloo
with CUDA tensors, and the mesh needs no more than ``all_reduce`` and
``broadcast`` over one flat axis.  The backend is always the caller's
choice (``parallel.distributed.init_distributed``).  Gloo runs only
``all_reduce`` and ``broadcast`` on CUDA tensors (it copies them through the
host and synchronises), so the mesh uses nothing else.

Without an initialised process group :func:`make_mesh` gives a mesh of one
rank whose collectives do nothing; with one, every collective runs, also on
a one-rank group.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.core.state import EnvState
from gym_collision_avoidance_torch.env.batch import batched_env_step
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.policies import registry as policies


class EnvMesh:
    """A 1-D ``("env",)`` mesh: ``size`` ranks of a process group, this
    process being rank ``rank`` on ``device``.  ``group`` is None for a mesh
    of one process without a process group."""

    def __init__(self, device: torch.device, group=None):
        self.device = device
        self.group = group
        self.size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.backend = None if group is None else dist.get_backend(group)

    def env_slice(self, num_envs_global: int) -> Tuple[int, int]:
        """``(start, count)`` of this rank's rows of the global env axis."""
        if num_envs_global % self.size:
            raise ValueError(f"num_envs_global={num_envs_global} must divide the "
                             f"{self.size}-rank mesh")
        count = num_envs_global // self.size
        return self.rank * count, count

    def psum(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum of ``tensor`` over the ranks, in place (one ``all_reduce``)."""
        if self.group is not None:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self.group)
        return tensor

    def pmean(self, tensor: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks: the sum, divided by the rank count (gloo has
        no ``ReduceOp.AVG``)."""
        return self.psum(tensor) / self.size

    def pmean_flat(self, tensors: dict) -> dict:
        """:meth:`pmean` of every tensor of ``{name: tensor}`` (one dtype),
        through one flattened buffer and one collective."""
        if self.group is None:
            return tensors
        names = list(tensors)
        flat = self.pmean(torch.cat([tensors[k].reshape(-1) for k in names]))
        out, at = {}, 0
        for k in names:
            n = tensors[k].numel()
            out[k] = flat[at:at + n].view_as(tensors[k])
            at += n
        return out

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``tensor`` on every rank, in place."""
        if self.group is not None:
            dist.broadcast(tensor, src=src, group=self.group)
        return tensor


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(num_devices: Optional[int] = None, device_type: str = "cuda",
              device=None) -> EnvMesh:
    """The ``("env",)`` mesh over every rank of the process group.

    Args:
        num_devices: the mesh's rank count; None means the whole world.
            Without a process group only 1 (or None) is possible.
        device_type: ``"cuda"`` (the default; raises without CUDA) or
            ``"cpu"``.
        device: this rank's device; default ``cuda:<local rank % visible
            cards>`` (``LOCAL_RANK``, as ``torchrun`` sets it, else the
            global rank), or the CPU.
    """
    if device is None:
        if device_type == "cuda":
            resolve_device("cuda")
            device = torch.device("cuda", _local_rank() % torch.cuda.device_count())
        else:
            device = torch.device(device_type)
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f"a mesh of {num_devices} devices needs {num_devices} ranks: "
                             "call parallel.distributed.init_distributed first")
        return EnvMesh(device)
    world = dist.get_world_size()
    if num_devices not in (None, world):
        raise ValueError(f"num_devices={num_devices}, but the process group has {world} ranks")
    return EnvMesh(device, dist.group.WORLD)


def shard_env_batch(batch, mesh: EnvMesh):
    """This rank's rows of a global ``[E, ...]`` batch (an EnvState, a
    tensor, or a dict, list or tuple of them), copied to the mesh's device:
    the counterpart of placing the batch with the env axis sharded."""
    def rows(x):
        start, count = mesh.env_slice(x.shape[0])
        return x[start:start + count].to(mesh.device, copy=True)

    if isinstance(batch, EnvState):
        return batch.map(rows)
    if isinstance(batch, dict):
        return {k: shard_env_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_env_batch(v, mesh) for v in batch)
    return rows(batch)


def stack_states(state_list) -> EnvState:
    """Env batches (e.g. one-env ``[1, A]`` states) concatenated along the
    env axis into one ``[E, A]`` batch."""
    first, *rest = state_list
    return first.map(lambda *xs: torch.cat(xs), *rest)


def make_batched_step(
    cfg: EnvConfig,
    active_policies: Tuple[int, ...] = (policies.NONCOOP,),
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
    has_external: bool = False,
):
    """A step over an ``[E, A, ...]`` env batch, whole or one rank's slice.

    Returns ``(states, ext_actions?, params=None) -> (states, obs, rewards,
    game_over [E], info)``; ``ext_actions`` only with ``has_external``.
    """
    def stepper(states, ext_actions, params):
        return batched_env_step(states, ext_actions, cfg, params, active_policies, sensors,
                                states_in_obs)

    if has_external:
        return lambda states, ext_actions, params=None: stepper(states, ext_actions, params)
    return lambda states, params=None: stepper(states, None, params)


def make_batched_rollout(
    cfg: EnvConfig,
    num_steps: int,
    active_policies: Tuple[int, ...] = (policies.NONCOOP,),
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
    mesh: Optional[EnvMesh] = None,
):
    """``num_steps`` lockstep steps of an env batch, returning only the
    per-step ``mean_reward`` and ``done_frac`` (``[num_steps]`` each).

    With ``mesh``, ``states`` is this rank's slice and both metrics are over
    the global batch: the per-step sums are stacked and reduced in one
    collective after the loop.  ``None`` means a mesh of this process alone.

    Returns ``run(states) -> (final_states, metrics)``.
    """
    def run(states):
        ranks = EnvMesh(states.pos.device) if mesh is None else mesh
        rewards, dones = [], []
        for _ in range(num_steps):
            states, _obs, rew, game_over, _info = batched_env_step(
                states, None, cfg, None, active_policies, sensors, states_in_obs)
            rewards.append(rew)
            dones.append(game_over)
        rew, done = torch.stack(rewards), torch.stack(dones).to(torch.float32)
        E, A = rew.shape[1:]
        sums = ranks.psum(torch.stack([rew.sum(dim=(1, 2)), done.sum(dim=1).to(rew.dtype)]))
        E_global = E * ranks.size
        return states, {"mean_reward": sums[0] / (E_global * A),
                        "done_frac": (sums[1] / E_global).to(torch.float32)}

    return run


def pool_rows(pool: np.ndarray, start: int, count: int) -> np.ndarray:
    """Pool cases ``(start + i) % N`` of global envs ``start .. start +
    count - 1``: the unsharded batch's rows for one slice."""
    return pool[(start + np.arange(count)) % len(pool)]
