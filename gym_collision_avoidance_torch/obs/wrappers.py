"""Observation flattening (port of
:mod:`gym_collision_avoidance_tpu.obs.wrappers`), replacing the reference's
``envs/wrappers.py``.

The reference wraps its env in gym ObservationWrappers that flatten the
per-agent dict obs into arrays with index bookkeeping
(``MultiagentFlattenDictWrapper`` / ``MultiagentDictToMultiagentArrayWrapper``,
envs/wrappers.py:11-173).  The port's obs is a dict of ``[E, A, ...]``
tensors, so flattening is reshape and concatenation; :class:`ObsLayout`
carries the same index bookkeeping (key -> slice) for the inverse.

Axis convention: the per-agent layout is that of the JAX package.  A key's
``shape`` is the trailing dims after the agent axis, and ``agent_size`` counts
them over all keys.  :meth:`ObsLayout.to_array` gives ``[..., A, agent_size]``
(``[E, A, agent_size]`` for the port's obs), :meth:`ObsLayout.to_flat`
``[..., A * agent_size]``, and :meth:`ObsLayout.to_dict` inverts
``to_array``.  For each env the flat order is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ObsLayout:
    """Index bookkeeping: key -> (low, high) within one agent's flat obs."""

    keys: Tuple[str, ...]
    slices: Dict[str, Tuple[int, int]]
    shapes: Dict[str, Tuple[int, ...]]
    agent_size: int

    @staticmethod
    def from_obs(obs: Dict[str, torch.Tensor], keys: Sequence[str]) -> "ObsLayout":
        """The layout of ``[E, A, ...]`` obs: each key's shape drops the env
        and agent axes."""
        slices, shapes = {}, {}
        size = 0
        for key in keys:
            shape = tuple(obs[key].shape[2:])
            n = int(np.prod(shape)) if shape else 1
            slices[key] = (size, size + n)
            shapes[key] = shape
            size += n
        return ObsLayout(tuple(keys), slices, shapes, size)

    def to_array(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dict obs -> ``[..., A, agent_size]`` (the
        MultiagentDictToMultiagentArrayWrapper layout, wrappers.py:164-173)."""
        parts = []
        for key in self.keys:
            x = obs[key]
            lead = x.shape[:x.dim() - len(self.shapes[key])]
            parts.append(x.reshape(tuple(lead) + (-1,)))
        return torch.cat(parts, dim=-1)

    def to_flat(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dict obs -> ``[..., A * agent_size]``, one vector per env (the
        MultiagentFlattenDictWrapper layout, wrappers.py:55-63)."""
        arr = self.to_array(obs)
        return arr.reshape(tuple(arr.shape[:-2]) + (-1,))

    def to_dict(self, array: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`to_array` (wrappers.py:65-77)."""
        out = {}
        for key in self.keys:
            lo, hi = self.slices[key]
            out[key] = array[..., lo:hi].reshape(tuple(array.shape[:-1]) + self.shapes[key])
        return out

    def agent_slice(self, agent: int) -> Tuple[int, int]:
        """Bounds of one agent inside an env's flat vector (wrappers.py:125-133)."""
        return agent * self.agent_size, (agent + 1) * self.agent_size
