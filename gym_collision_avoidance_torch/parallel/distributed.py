"""Multi-process runtime for the env batch (port of
:mod:`gym_collision_avoidance_tpu.parallel.distributed`).

* every process calls :func:`init_distributed` with its backend (``nccl``
  when each rank has a card of its own, ``gloo`` on the CPU or for ranks
  that share one card), so that all join one ``torch.distributed`` process
  group;
* :func:`global_mesh` is the ``("env",)`` mesh over every rank
  (:class:`parallel.mesh.EnvMesh`);
* each rank builds only its own slice of the env batch
  (:func:`host_local_batch`); the global ``[E, ...]`` batch never exists in
  one process;
* :func:`save_sharded_state` and :func:`load_sharded_state` write a
  training carry whose env rows are sharded as one file in global row
  order and read it back at any rank count (:func:`gather_env_rows`, then
  ``mesh.shard_env_batch``);
* :func:`make_distributed_rollout` steps the slice and reduces its metrics
  once a dispatch: the per-step scalars are stacked over the loop and one
  ``all_reduce`` of the stacked ``[2, num_steps]`` buffer gives every rank
  the global ``mean_reward`` (mean over ranks) and ``done_count`` (sum).

With no coordinator configured :func:`init_distributed` does nothing, and
the mesh is one process, so single-process code takes the same path.

A program that starts its own local ranks (the dry run, the scaling
scripts) picks their backend with :func:`choose_backend` (NCCL needs a card
a rank), runs them with :func:`run_rank_job` (each rank joins with
:func:`join_rank_job` and returns a dict with :func:`save_rank_result`), and
times a window on every rank with :func:`timed_over_ranks`: a barrier that
drains each device, then the slowest rank's time.

Launch: ``scripts/launch_multihost_torch.py`` (one process per host or card;
``--spawn N`` starts N local ranks), ``torchrun``, or :func:`spawn_local`.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.state import EnvState
from gym_collision_avoidance_torch.env.batch import batched_env_step
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.parallel.mesh import EnvMesh, make_mesh, shard_env_batch
from gym_collision_avoidance_torch.policies import registry as policies
from gym_collision_avoidance_torch.utils import checkpoint

BACKENDS = ("nccl", "gloo")


def choose_backend(device_type: str, num_ranks: int, backend: Optional[str] = None) -> str:
    """The backend of ``num_ranks`` local ranks on ``device_type``: the
    caller's, or NCCL on ``cuda`` and gloo on ``cpu`` when it is None.

    NCCL needs a card of its own for each rank: it refuses two ranks on one
    card, so NCCL with more ranks than visible cards raises, as NCCL on the
    CPU does.  Gloo ranks share a card only when the caller asks for gloo.
    There is no fallback from one backend to the other.
    """
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("NCCL runs on CUDA cards only; use backend='gloo' on the CPU")
        cards = torch.cuda.device_count()
        if num_ranks > cards:
            raise RuntimeError(f"NCCL needs one card per rank: {num_ranks} ranks, {cards} "
                               "visible cards (backend='gloo' lets ranks share a card)")
    return backend


def init_distributed(
    backend: Optional[str] = None,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    init_method: Optional[str] = None,
) -> bool:
    """Join the process group (``torch.distributed.init_process_group``).

    The rendezvous is ``init_method`` (e.g. ``file:///.../rendezvous``), or
    ``tcp://<coordinator_address>`` (``host:port`` of process 0), or the
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` variables, which
    ``torchrun`` sets.  With none of them this is a no-op that returns False
    (single-process mode), so library code may call it unconditionally.

    ``backend`` must be given when there is a group to join: ``"nccl"``
    (one card per rank) or ``"gloo"``.  It is never chosen by a fallback.

    Returns True if a process group was initialised.
    """
    env = os.environ
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"init_distributed needs backend 'nccl' (one card per rank) or "
                         f"'gloo', got {backend!r}")
    if dist.is_initialized():
        raise RuntimeError("the process group is initialised already")
    world = int(env["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return True


def global_mesh(device_type: str = "cuda") -> EnvMesh:
    """The ``("env",)`` mesh over every rank of every host (after
    :func:`init_distributed`)."""
    return make_mesh(None, device_type)


def process_env_slice(num_envs_global: int, mesh: EnvMesh) -> Tuple[int, int]:
    """``(start, count)`` of this rank's contiguous rows of the global env
    axis; raises unless the rank count divides ``num_envs_global``."""
    return mesh.env_slice(num_envs_global)


def host_local_batch(build_fn: Callable, num_envs_global: int, mesh: EnvMesh):
    """This rank's slice of the global env batch, built locally.

    ``build_fn(global_indices)`` gets the ``[count]`` int64 numpy array of
    this rank's global env indices and returns their ``[count, ...]`` batch
    (the port's states are batched, so one call builds the slice; the JAX
    package calls its ``build_fn`` once per env).
    """
    start, count = process_env_slice(num_envs_global, mesh)
    return build_fn(np.arange(start, start + count, dtype=np.int64))


def _tensors(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.state_dict(keep_vars=True).values())
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


@torch.no_grad()
def replicate_global(tree, mesh: EnvMesh):
    """Broadcast rank 0's tensors of ``tree`` (a module, tensor, or a dict,
    list or tuple of them, e.g. policy params) to every rank in place, so
    that every replica starts from the same bits: one flattened buffer and
    one ``broadcast`` per dtype.  Returns ``tree``."""
    if mesh.group is None:
        return tree
    by_dtype = {}
    for t in _tensors(tree, []):
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        ts = by_dtype[dtype]
        flat = mesh.broadcast(torch.cat([t.detach().reshape(-1).to(mesh.device) for t in ts]))
        at = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[at:at + n].view(t.shape))
            at += n
    return tree


def _map_leaves(tree, fn):
    """``tree`` (a tensor, an EnvState, or a dict, list or tuple of them)
    with every tensor ``t`` replaced by ``fn(t)``, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, EnvState):
        return tree.map(fn)
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    raise TypeError(f"no env rows in a {type(tree).__name__}")


@torch.no_grad()
def gather_env_rows(tree, mesh: EnvMesh):
    """Every rank's rows of ``tree``'s tensors (each ``[E/D, ...]``, this
    rank's block of the global env axis) joined in global row order, ``[E,
    ...]`` on every rank: the counterpart of ``np.asarray`` of a sharded
    array.  Each rank broadcasts its leaves' bytes in turn (one ``broadcast``
    a rank), so every bit, -0.0 and NaN payloads included, arrives as it
    was.  A one-process mesh returns ``tree``."""
    if mesh.group is None:
        return tree
    leaves = []
    _map_leaves(tree, leaves.append)
    local = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in leaves])
    blocks = [mesh.broadcast(local.clone() if r == mesh.rank else torch.empty_like(local), src=r)
              for r in range(mesh.size)]
    joined, at = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        joined.append(torch.cat([b[at:at + n].clone().view(t.dtype).view(t.shape)
                                 for b in blocks]))
        at += n
    rows = iter(joined)
    return _map_leaves(tree, lambda _t: next(rows))


def save_sharded_state(path: str, carry: tuple, row_items: Sequence[int], mesh: EnvMesh) -> str:
    """Write a carry whose items ``row_items`` hold this rank's env rows as
    one file in the unsharded layout (``utils.checkpoint.save_state``), as
    the JAX package saves a sharded carry whole: those items gathered in
    global row order (:func:`gather_env_rows`), the other (replicated) items
    as they are.  Every rank calls it; rank 0 writes, and the others return
    once the file is there.  Returns ``path``."""
    from gym_collision_avoidance_torch.utils import checkpoint

    whole = tuple(gather_env_rows(x, mesh) if i in row_items else x
                  for i, x in enumerate(carry))
    if mesh.rank == 0:
        checkpoint.save_state(path, whole)
    mesh.psum(torch.zeros((), device=mesh.device)).item()
    return path


def load_sharded_state(path: str, like: tuple, row_items: Sequence[int], mesh: EnvMesh) -> tuple:
    """Read a file of :func:`save_sharded_state` (or ``save_state``), saved
    at any rank count that divides the env count, into this rank's carry:
    items ``row_items`` are this rank's rows of the file's global rows
    (``mesh.shard_env_batch``), the others as saved; structure, dtypes and
    devices those of ``like``, whose row items have this rank's rows."""
    def widen(t):
        return t.new_empty((t.shape[0] * mesh.size,) + tuple(t.shape[1:]))

    whole = checkpoint.load_state(path, tuple(_map_leaves(x, widen) if i in row_items else x
                                              for i, x in enumerate(like)))
    return tuple(shard_env_batch(x, mesh) if i in row_items else x for i, x in enumerate(whole))


def make_distributed_rollout(
    cfg: EnvConfig,
    num_steps: int,
    mesh: EnvMesh,
    active_policies: Tuple[int, ...] = (policies.NONCOOP,),
    sensors: Tuple[str, ...] = ("other_agents_states",),
    states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
    with_params: bool = False,
):
    """``num_steps`` lockstep steps of this rank's env slice.

    Each step's ``mean_reward`` (over the slice) and ``done_count`` are kept
    on the device; after the loop one ``all_reduce`` of the stacked
    ``[2, num_steps]`` buffer gives the mean over ranks of ``mean_reward``
    and the sum of ``done_count``, the same ``[num_steps]`` vectors on every
    rank: one collective a dispatch, not two a step.

    Returns ``run(states[, params]) -> (final_states, metrics)``.
    """
    def run(states, params=None):
        rewards, dones = [], []
        for _ in range(num_steps):
            states, _obs, rew, game_over, _info = batched_env_step(
                states, None, cfg, params, active_policies, sensors, states_in_obs)
            rewards.append(torch.mean(rew))
            dones.append(torch.sum(game_over.to(rew.dtype)))
        buf = mesh.psum(torch.stack([torch.stack(rewards), torch.stack(dones)]))
        return states, {"mean_reward": buf[0] / mesh.size,
                        "done_count": buf[1].to(torch.float32)}

    if with_params:
        return run
    return lambda states: run(states)


def sync_ranks(mesh: EnvMesh) -> None:
    """Wait until this rank's device has finished its queued work and every
    rank has got here: a barrier that also drains the device, so that a
    window timed after it starts on every rank together."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.psum(torch.zeros(1, device=mesh.device)).item()


def gather_scalars(mesh: EnvMesh, value: float) -> List[float]:
    """Every rank's ``value``, in rank order, on every rank (one
    ``all_reduce`` of a ``[D]`` float64 buffer that holds each rank's value
    in its own slot)."""
    buf = torch.zeros(mesh.size, dtype=torch.float64, device=mesh.device)
    buf[mesh.rank] = float(value)
    return mesh.psum(buf).tolist()


def timed_over_ranks(mesh: EnvMesh, fn: Callable):
    """``(seconds, fn())``: the window from a :func:`sync_ranks` to the end
    of ``fn``'s device work on the slowest rank, the maximum over the ranks
    of each one's window (taken after the window closes), the same on every
    rank."""
    sync_ranks(mesh)
    t0 = time.perf_counter()
    out = fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    seconds = time.perf_counter() - t0
    return max(gather_scalars(mesh, seconds)), out


def run_rank_job(command: Sequence[str], num_processes: int, threads: Optional[int] = 1,
                 timeout: Optional[float] = None) -> List[dict]:
    """Run ``command`` on ``num_processes`` local ranks (:func:`spawn_local`)
    with ``--rank-out DIR`` appended; each rank saves its result dict with
    :func:`save_rank_result`.  Returns the results in rank order; raises
    :class:`RankFailed` if a rank fails."""
    with tempfile.TemporaryDirectory(prefix="gca_job_") as out:
        spawn_local([*command, "--rank-out", out], num_processes, threads=threads,
                    timeout=timeout, capture=True)
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(num_processes)]


def add_rank_flags(parser) -> None:
    """The flags that :func:`spawn_local` and :func:`run_rank_job` append to
    a rank's command, hidden from ``--help``."""
    for flag, kind in (("--init-method", str), ("--num-processes", int),
                       ("--process-id", int), ("--rank-out", str)):
        parser.add_argument(flag, type=kind, default=None, help=argparse.SUPPRESS)


def join_rank_job(args, backend: str, device_type: str) -> EnvMesh:
    """A rank of :func:`run_rank_job` (``args`` parsed with
    :func:`add_rank_flags`): join the process group over ``backend`` and
    return the mesh, this rank on its ``device_type`` device."""
    init_distributed(backend, num_processes=args.num_processes, process_id=args.process_id,
                     init_method=args.init_method)
    return make_mesh(device_type=device_type)


def save_rank_result(args, mesh: EnvMesh, result: dict) -> None:
    """A rank's side of :func:`run_rank_job`: write ``result`` (tensors,
    numbers, lists and dicts) where the parent reads it, and leave the
    process group."""
    torch.save(result, os.path.join(args.rank_out, f"rank{mesh.rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


class RankFailed(RuntimeError):
    """A rank started by :func:`spawn_local` failed or timed out."""


def spawn_local(command: Sequence[str], num_processes: int, threads: Optional[int] = 1,
                timeout: Optional[float] = None,
                capture: bool = False) -> List[subprocess.CompletedProcess]:
    """Run ``num_processes`` local copies of ``command``, the ranks of one
    process group.

    Each copy gets ``--init-method file://<tmp>/rendezvous --num-processes N
    --process-id i`` appended (a file rendezvous: no port to collide with
    other runs on the machine), and ``OMP_NUM_THREADS=threads`` unless
    ``threads`` is None.  When one rank fails, or ``timeout`` seconds pass,
    the others are stopped (a rank would otherwise wait in a collective
    forever) and :class:`RankFailed` is raised with the ranks' output.

    Returns each rank's ``CompletedProcess`` (``stdout``/``stderr`` are text
    with ``capture``, else None: the ranks write to this process's streams).
    """
    child_env = dict(os.environ)
    if threads is not None:
        child_env["OMP_NUM_THREADS"] = str(threads)
    with tempfile.TemporaryDirectory(prefix="gca_spawn_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs, logs = [], []
        for i in range(num_processes):
            argv = [*command, "--init-method", init, "--num-processes", str(num_processes),
                    "--process-id", str(i)]
            out = open(os.path.join(tmp, f"{i}.out"), "w+") if capture else None
            err = open(os.path.join(tmp, f"{i}.err"), "w+") if capture else None
            logs.append((out, err))
            procs.append(subprocess.Popen(argv, stdout=out, stderr=err, env=child_env))
        deadline = None if timeout is None else time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or (deadline is not None and time.monotonic() > deadline):
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad else \
                    f"timeout after {timeout} s"
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if failed is None and any(p.returncode for p in procs):
            bad = next(i for i, p in enumerate(procs) if p.returncode)
            failed = f"rank {bad} exited {procs[bad].returncode}"
        results = []
        for i, (p, (out, err)) in enumerate(zip(procs, logs)):
            texts = []
            for f in (out, err):
                if f is None:
                    texts.append(None)
                else:
                    f.seek(0)
                    texts.append(f.read())
                    f.close()
            results.append(subprocess.CompletedProcess(p.args, p.returncode, *texts))
    if failed is not None:
        detail = "".join(f"\n--- rank {i} stderr:\n{(r.stderr or '')[-4000:]}"
                         for i, r in enumerate(results))
        raise RankFailed(f"{failed}{detail}")
    return results

