"""A one-step check of the batched env engine and a dry run over ranks (the
counterpart of the JAX repo's root ``__graft_entry__.py``).

* :func:`entry` returns ``(fn, args)``: one forward step of
  ``env.batch.batched_env_step`` over 8 envs of 4 GA3C-CADRL agents (the
  iros18 weights), the flagship model inside the step.
* :func:`dryrun_multichip` runs, on ``n`` ranks of one process group started
  with ``parallel.distributed.spawn_local``, each rank on its own slice of
  the env batch: (a) that step twice, its mean reward and done share reduced
  over the ranks; (b) ``make_distributed_rollout`` with the weights
  broadcast from rank 0; (c) one iteration of ``make_sharded_ppo``; (d) two
  dispatches of ``AutoresetServer(mesh=)``, which must complete episodes.

The backend is NCCL on the card and gloo on the CPU unless the caller names
one.  NCCL needs a card for each rank and raises with fewer; ranks share one
card only over gloo, and only when the caller asks for it.  There is no
fallback to the CPU.  Usage::

    fn, args = entry()                        # on the card
    states, rewards, game_over = fn(*args)
    dryrun_multichip(2, device="cpu")         # 2 gloo ranks on the CPU
    dryrun_multichip(2, backend="gloo")       # 2 gloo ranks sharing the card
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.env.batch import batched_env_step
from gym_collision_avoidance_torch.models import ga3c_cadrl
from gym_collision_avoidance_torch.scenarios import presets

RANK_TIMEOUT_S = 600   # a rank that has not finished by then is stopped
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a spawned rank: this module's rank_main on the arguments after the code
_RANK_CODE = (f"import sys; sys.path.insert(0, {_ROOT!r}); "
              "from gym_collision_avoidance_torch import entry; "
              "sys.exit(entry.rank_main(sys.argv[1:]))")


def repeat_envs(state, num_envs: int):
    """A ``[1, A]`` state repeated to ``num_envs`` envs."""
    return state.map(lambda x: x.repeat((num_envs,) + (1,) * (x.dim() - 1)))


def build_batch(num_envs: int, num_agents: int = 4, device=None):
    """``(cfg, scenario, states, params)``: ``num_envs`` copies of a circle of
    ``num_agents`` GA3C-CADRL agents (radius 3 m, agents 0.5 m) with the
    iros18 weights, 19 observed neighbours sorted closest last, float32."""
    device = resolve_device(device)
    cfg = EnvConfig(dtype="float32", max_num_other_agents_observed=19,
                    agent_sorting_method="closest_last")
    sc = presets.circle_scenario(num_agents, radius=3.0, agent_radius=0.5,
                                 policy="GA3C_CADRL")
    params = {"ga3c_cadrl": ga3c_cadrl.load_params("iros18", device=device)}
    return cfg, sc, repeat_envs(sc.to_state(cfg, device=device), num_envs), params


def entry(device=None):
    """``(fn, (states,))``: ``fn(states) -> (states, rewards, game_over)``,
    one ``batched_env_step`` of 8 envs (:func:`build_batch`)."""
    cfg, sc, states, params = build_batch(num_envs=8, device=device)
    active = sc.active_policies

    def fn(states):
        states, _obs, rew, game_over, _info = batched_env_step(states, None, cfg, params, active)
        return states, rew, game_over

    return fn, (states,)


def dryrun_rank(mesh) -> dict:
    """This rank's part of :func:`dryrun_multichip` over ``mesh`` (a
    :class:`parallel.mesh.EnvMesh` of ``n`` ranks, 2 envs each).  Returns its
    reduced metrics, its episode count and the kernel launches it made;
    raises if the server completed no episode."""
    from gym_collision_avoidance_torch import ops
    from gym_collision_avoidance_torch.env.step import env_reset
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer
    from gym_collision_avoidance_torch.parallel import distributed
    from gym_collision_avoidance_torch.scenarios import random_cases
    from gym_collision_avoidance_torch.train import PPOConfig, make_sharded_ppo

    ops.zero_launch_counts()
    t0 = time.perf_counter()
    n, device = mesh.size, mesh.device
    E = 2 * n
    cfg, sc, one, params = build_batch(1, device=device)
    active = sc.active_policies

    # (a) the batched step on this rank's slice, twice; metrics over the ranks
    states = distributed.host_local_batch(lambda idx: repeat_envs(one, len(idx)), E, mesh)
    step_metrics = []
    for _ in range(2):
        states, _obs, rew, game_over, _info = batched_env_step(states, None, cfg, params, active)
        sums = mesh.psum(torch.stack([rew.sum(), game_over.to(rew.dtype).sum()]))
        step_metrics.append({"mean_reward": float(sums[0] / (E * rew.shape[1])),
                             "done_frac": float(sums[1] / E)})

    # (b) the distributed rollout with the weights broadcast from rank 0
    base, _ = env_reset(sc.to_state(cfg, device=device), cfg)
    gstates = distributed.host_local_batch(lambda idx: repeat_envs(base, len(idx)), E, mesh)
    gparams = distributed.replicate_global(params, mesh)
    run = distributed.make_distributed_rollout(cfg, 2, mesh, active_policies=active,
                                               with_params=True)
    _final, gmetrics = run(gstates, gparams)

    # (c) one iteration of the sharded PPO trainer
    ppo_cfg = PPOConfig(num_envs=E, horizon=2, num_agents=2, epochs=1, num_minibatches=1)
    train, init_fn, _ = make_sharded_ppo(ppo_cfg, mesh)
    carry = init_fn(0)
    *carry, tmetrics = train(*carry, rng=torch.Generator(device).manual_seed(1))

    # (d) the auto-reset serving loop on the mesh, dispatched twice
    scfg = EnvConfig(dtype="float32", done_mode="evaluate")
    pool = random_cases.scenario_pool(8, 4, seed=0, side_length=4.0)
    server = AutoresetServer(scfg, pool, np.full(4, 1, np.int32), num_envs=E,
                             steps_per_dispatch=32, mesh=mesh)
    server.dispatch()
    out = server.dispatch()
    episodes = server.episodes_completed()
    if episodes <= 0:
        raise RuntimeError("sharded serving: no episode completed")
    return {"rank": mesh.rank, "size": n, "backend": mesh.backend, "device": str(device),
            "step_metrics": step_metrics,
            "rollout": {k: v.cpu().tolist() for k, v in gmetrics.items()},
            "ppo": {k: float(v) for k, v in tmetrics.items()},
            "serving_mean_reward": out["mean_reward"].cpu().tolist(), "episodes": episodes,
            "launches": ops.launch_counts(), "seconds": time.perf_counter() - t0}


def dryrun_multichip(n: int, device=None, backend=None) -> list:
    """Run :func:`dryrun_rank` on ``n`` local ranks, one process each, and
    return their results in rank order.

    ``device=None`` means the card (raises without CUDA); ``backend=None``
    means NCCL on ``cuda`` (one card a rank: more ranks than cards raise)
    and gloo on ``cpu``.  ``backend="gloo"`` on ``cuda`` puts ranks beyond
    the card count on shared cards.  The kernels are built here, so that the
    ranks only load them.  Raises ``parallel.distributed.RankFailed`` if a
    rank fails (no episode served, a kernel error, a timeout).
    """
    from gym_collision_avoidance_torch.parallel import distributed

    device = resolve_device(device)
    backend = distributed.choose_backend(device.type, n, backend)
    if device.type == "cuda":
        from gym_collision_avoidance_torch.ops import build

        build.build(["pairwise"])
    return distributed.run_rank_job(
        [sys.executable, "-c", _RANK_CODE, device.type, backend], n,
        threads=None if device.type == "cuda" else 1, timeout=RANK_TIMEOUT_S)


def rank_main(argv) -> int:
    """A rank of :func:`dryrun_multichip`: ``DEVICE_TYPE BACKEND`` and the
    flags that ``run_rank_job`` appends."""
    from gym_collision_avoidance_torch.parallel import distributed

    ap = argparse.ArgumentParser()
    ap.add_argument("device_type", choices=["cuda", "cpu"])
    ap.add_argument("backend", choices=list(distributed.BACKENDS))
    distributed.add_rank_flags(ap)
    args = ap.parse_args(argv)
    mesh = distributed.join_rank_job(args, args.backend, args.device_type)
    distributed.save_rank_result(args, mesh, dryrun_rank(mesh))
    return 0
