"""Serving loop: continuous batched episodes with auto-reset (port of
:mod:`gym_collision_avoidance_tpu.harness.serving`).

Example::

    server = AutoresetServer(cfg, pool, policy_id, num_envs=16384)
    for _ in range(100):
        out = server.dispatch()        # enqueues S steps on the card
    print(server.episodes_completed()) # syncs

``dispatch`` runs ``steps_per_dispatch`` steps in a Python loop of eager
PyTorch calls and returns per-step stacked outputs ``[S, ...]``: the
requested ``collect`` obs keys, ``mean_reward`` and ``obs_checksum``, and
with a fast laserscan route ``exactness_overflow``.  It does not
synchronise; reading a value does.  A profiler's trace marks each call
``gca.dispatch``, around the phase spans of its steps
(:mod:`utils.profiling`).

With ``mesh`` (a :class:`parallel.mesh.EnvMesh`) every rank builds and steps
only its slice of the ``num_envs`` envs, and its counters start at the
slice's global indices, so each env picks the pool case it picks unsharded.
The metrics are reduced over the mesh at the end of each dispatch, in one
``all_reduce`` of one stacked buffer (the per-step sums of the slice), so
``dispatch`` returns what an unsharded server returns.  Reducing there
rather than when a value is read keeps ``dispatch``'s return a plain dict
of tensors and costs one collective a dispatch, not one a step.  Over NCCL
the collective is queued on the stream; over gloo it copies the buffer
through the host and so waits for the dispatch to finish, which costs
little on a loop that the host, not the card, holds back.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.env import autoreset
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.parallel.mesh import EnvMesh, pool_rows
from gym_collision_avoidance_torch.utils import profiling


class AutoresetServer:
    """Continuous steady-state serving of batched episodes.

    Args:
        cfg: env config.
        pool: ``[N, A, 6]`` (or ``[N, A, 7]``) scenario pool, as made by
            ``scenarios.random_cases.scenario_pool``.
        policy_id: ``[A]`` int policy ids applied to every episode.
        num_envs: batch width E.
        steps_per_dispatch: env steps per :meth:`dispatch` (S).
        collect: obs keys returned stacked per dispatch.
        active_policies / params / sensors / states_in_obs: as in
            :func:`env.autoreset.make_autoreset_step`.
        static_map / static_cells: map inputs of laserscan and occupancy
            configs (as in ``env.step.env_step``).  With a fast laserscan
            route the step's exactness guard is gathered every step, per
            dispatch (``out["exactness_overflow"]``, ``[S]`` bool) and since
            construction (:meth:`exactness_overflow`).
        device: ``None`` means CUDA (raises if it is absent), or the
            mesh's device.
        mesh: an :class:`parallel.mesh.EnvMesh`; ``num_envs`` is then the
            global count, which the mesh's rank count must divide.  ``None``
            means a mesh of this process alone.
    """

    def __init__(
        self,
        cfg: EnvConfig,
        pool,
        policy_id,
        num_envs: int = 4096,
        steps_per_dispatch: int = 256,
        collect: Tuple[str, ...] = (),
        active_policies: Optional[Tuple[int, ...]] = None,
        params=None,
        sensors: Sequence[str] = ("other_agents_states",),
        states_in_obs: Sequence[str] = obs_spec.DEFAULT_STATES_IN_OBS,
        static_map=None,
        static_cells=None,
        device=None,
        mesh=None,
    ):
        self.device = resolve_device(mesh.device if device is None and mesh else device)
        self.mesh = mesh = EnvMesh(self.device) if mesh is None else mesh
        pool = np.asarray(pool)
        policy_id = np.asarray(policy_id, np.int32)
        if active_policies is None:
            active_policies = tuple(sorted({int(p) for p in policy_id}))
        self._step = autoreset.make_autoreset_step(
            cfg, pool, policy_id, active_policies, tuple(sensors),
            tuple(states_in_obs), params, device=self.device,
            static_map=static_map, static_cells=static_cells, return_info=True,
        )
        self.num_envs = int(num_envs)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.collect = tuple(collect)
        self._n_agents = int(policy_id.shape[0])
        start, count = mesh.env_slice(self.num_envs)
        self._first = torch.arange(start, start + count, dtype=torch.int32,
                                   device=self.device)
        self._states = autoreset.state_from_case(
            cfg, pool_rows(pool, start, count), policy_id, device=self.device
        )
        self._counters = self._first.clone()
        self._overflow = torch.zeros((), dtype=torch.bool, device=self.device)

    def dispatch(self):
        """Run S steps; returns stacked ``[S, ...]`` outputs without
        synchronising."""
        with profiling.span("gca.dispatch"):
            outs = {k: [] for k in self.collect}
            rewards, checksums, overflows = [], [], []
            st, c = self._states, self._counters
            for _ in range(self.steps_per_dispatch):
                st, c, obs, rew, _go, info = self._step(st, c)
                for k in self.collect:
                    outs[k].append(obs[k])
                rewards.append(rew.sum(dim=-1))                  # [E]
                checksums.append(obs["dist_to_goal"].sum(dim=-1))  # [E, A]
                if "laserscan_exactness_overflow" in info:
                    overflows.append(info["laserscan_exactness_overflow"].any())
            self._states, self._counters = st, c
            out = {k: torch.stack(v) for k, v in outs.items()}
            out.update(self._reduce(rewards, checksums, overflows))
            if overflows:
                self._overflow = self._overflow | out["exactness_overflow"].any()
        return out

    def _reduce(self, rewards, checksums, overflows):
        """The dispatch's metrics over the mesh: the slice's per-step sums
        ``[S, 1 + A (+ 1)]`` in one buffer and one ``all_reduce``."""
        sums = [torch.stack(rewards).sum(dim=1, keepdim=True), torch.stack(checksums).sum(dim=1)]
        if overflows:
            sums.append(torch.stack(overflows).to(sums[0].dtype)[:, None])
        buf = self.mesh.psum(torch.cat(sums, dim=1))
        out = {"mean_reward": buf[:, 0] / self.num_envs / self._n_agents,
               "obs_checksum": buf[:, 1:1 + self._n_agents]}
        if overflows:
            out["exactness_overflow"] = buf[:, -1] > 0
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def states(self):
        """Current ``[E, A]`` env states (with a mesh, this rank's slice),
        synchronised."""
        self._sync()
        return self._states

    def counters(self):
        """Current ``[E]`` pool counters (with a mesh, this rank's slice),
        synchronised: env e's episodes so far plus its first case."""
        self._sync()
        return self._counters

    def episodes_completed(self) -> int:
        """Total episodes finished since construction over every env (syncs),
        summed in int64.  With a mesh it is a collective: every rank calls
        it."""
        done = torch.sum(self._counters.to(torch.int64) - self._first.to(torch.int64))
        return int(self.mesh.psum(done.reshape(1)))

    def exactness_overflow(self) -> bool:
        """True if any step since construction tripped the laserscan
        exactness guard (always False without a fast laserscan route;
        syncs)."""
        return bool(self._overflow)

    def throughput(self, reps: int = 3, pipeline: int = 8):
        """Measured steady-state env-steps/s: median of ``reps``, each
        timing ``pipeline`` dispatches, host clock around work that ends in
        ``torch.cuda.synchronize()``."""
        self.dispatch()           # warmup
        self._sync()
        rates = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _p in range(pipeline):
                self.dispatch()
            self._sync()
            rates.append(
                pipeline * self.num_envs * self.steps_per_dispatch
                / (time.perf_counter() - t0)
            )
        rates.sort()
        return rates[len(rates) // 2]
