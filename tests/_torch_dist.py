"""Runs a job on N gloo CPU ranks of the port, for the sharded tests.

A test writes a job (a dict: the cases to run and their inputs) with
``torch.save`` and calls :func:`run_ranks`, which starts N copies of this
file through ``parallel.distributed.run_rank_job`` (a file rendezvous, one
intra-op thread each) and returns each rank's results.  A rank runs every
case of the job on its slice of the env batch and saves ``{case: result}``.
This file imports neither jax nor the JAX package, so a rank starts in a few
seconds.
"""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from gym_collision_avoidance_torch import EnvConfig, convert  # noqa: E402
from gym_collision_avoidance_torch.parallel import distributed as dist  # noqa: E402
from gym_collision_avoidance_torch.parallel import mesh as pmesh  # noqa: E402

DEVICE = "cpu"


def run_ranks(job, num_ranks, tmp_path, timeout=240):
    """Run ``job`` on ``num_ranks`` ranks; returns their results in rank
    order."""
    job_file = os.path.join(tmp_path, f"job{num_ranks}.pt")
    torch.save(job, job_file)
    return dist.run_rank_job([sys.executable, os.path.abspath(__file__), job_file], num_ranks,
                             timeout=timeout)


def record_grads(trainer):
    """Make ``trainer`` keep the gradients that each of its minibatch steps
    applies (averaged over the ranks), ``{name: array}`` each, in the list
    it returns."""
    seen, step = [], trainer.minibatch_step

    def spy(params, opt_state, mb):
        out = step(params, opt_state, mb)
        seen.append({k: v.detach().cpu().numpy().copy() for k, v in out[0].items()})
        return out

    trainer.minibatch_step = spy
    return seen


def shard_mean_loss(trainer, perm, num_ranks):
    """Make an unsharded ``trainer``'s loss, for one epoch of one minibatch
    shuffled by ``perm``, the mean over ``num_ranks`` ranks of each rank's
    loss on its own streams' samples: the loss whose gradient a sharded run
    averages over the ranks, each rank normalising its alive-weighted means
    by its own alive count (as the JAX package's ``pmean`` of the shards'
    gradients does).  Minibatch row ``i`` is a sample of stream ``perm[i //
    T]``."""
    shard = (perm // (trainer.B // num_ranks)).repeat_interleave(trainer.ppo.horizon)
    loss_fn = trainer.loss_fn

    def loss(params, mb):
        parts = [loss_fn(params, {k: v[shard == r] for k, v in mb.items()})
                 for r in range(num_ranks)]
        return sum(p[0] for p in parts) / num_ranks, parts[0][1]

    trainer.loss_fn = loss
    return trainer


# ------------------------------------------------------------------ cases


def case_server(mesh, job):
    """``AutoresetServer(mesh=)``: every dispatch's outputs, the final slice
    and counters, the global episode count."""
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer

    kw = job["server"]
    server = AutoresetServer(EnvConfig(**kw["cfg"]), kw["pool"], kw["policy_id"],
                             num_envs=kw["num_envs"], steps_per_dispatch=kw["steps"],
                             mesh=mesh)
    outs = [{k: v.clone() for k, v in server.dispatch().items()}
            for _ in range(kw["dispatches"])]
    return {"outs": outs, "states": convert.state_to_numpy(server.states()),
            "counters": server._counters.clone(), "episodes": server.episodes_completed()}


def case_batched_step(mesh, job):
    """``make_batched_step`` with GA3C weights (broadcast from rank 0) on
    this rank's slice of the job's states."""
    from gym_collision_avoidance_torch.models import ga3c_cadrl

    kw = job["batched_step"]
    params = {"ga3c_cadrl": dist.replicate_global(ga3c_cadrl.load_params(device=DEVICE), mesh)}
    states = pmesh.shard_env_batch(convert.state_from_numpy(kw["states"], device=DEVICE), mesh)
    step = pmesh.make_batched_step(EnvConfig(**kw["cfg"]), kw["active"])
    st, obs, rew, game_over, _ = step(states, params)
    return {"states": convert.state_to_numpy(st), "obs": obs, "rewards": rew, "game_over": game_over}


def case_rollout(mesh, job):
    """``make_distributed_rollout`` and ``make_batched_rollout(mesh=)`` on
    this rank's slice."""
    kw = job["rollout"]
    cfg = EnvConfig(**kw["cfg"])
    states = convert.state_from_numpy(kw["states"], device=DEVICE)
    local = dist.host_local_batch(lambda idx: states.map(lambda x: x[torch.as_tensor(idx)]),
                                  states.num_envs, mesh)
    final, metrics = dist.make_distributed_rollout(cfg, kw["steps"], mesh, kw["active"])(local)
    final_b, metrics_b = pmesh.make_batched_rollout(cfg, kw["steps"], kw["active"],
                                                    mesh=mesh)(local)
    return {"states": convert.state_to_numpy(final), "metrics": metrics,
            "batched_states": convert.state_to_numpy(final_b), "batched_metrics": metrics_b}


def case_ppo(mesh, job, name):
    """``make_sharded_ppo``: its own init carry, then one ``train_step`` from
    the job's global carry (this rank's rows) with the job's noise or a
    generator seeded with the job's seed, and that generator's draws."""
    from gym_collision_avoidance_torch.train import ppo as tppo

    kw = job[name]
    cfg = EnvConfig(**kw["cfg"]) if kw.get("cfg") else None
    step, init_fn, _ = tppo.make_sharded_ppo(tppo.PPOConfig(**kw["ppo"]), mesh, cfg=cfg)
    trainer = step.__self__
    init = init_fn(kw["ppo"]["seed"])
    arch = kw["ppo"]["policy_arch"]
    params = convert.ppo_params_from_numpy(arch, kw["params"], device=DEVICE)
    carry = pmesh.shard_env_batch(
        (convert.state_from_numpy(kw["states"], device=DEVICE), torch.as_tensor(kw["counters"]),
         {k: torch.as_tensor(v) for k, v in kw["obs"].items()}), mesh)
    opt = tppo.optim.init(tppo.trainable_params(params))
    grads = record_grads(trainer)
    if "noise" in kw:
        out = step(params, opt, *carry, noise=kw["noise"])
        drawn = None
    else:
        drawn = trainer.sample_noise(torch.Generator().manual_seed(kw["rng"]))
        out = step(params, opt, *carry, rng=torch.Generator().manual_seed(kw["rng"]))
    return {"init": {"params": convert.ppo_params_to_numpy(arch, init[0]),
                     "states": convert.state_to_numpy(init[2]), "counters": init[3], "obs": init[4]},
            "params": convert.ppo_params_to_numpy(arch, out[0]), "states": convert.state_to_numpy(out[2]),
            "counters": out[3], "obs": out[4], "metrics": {k: float(v) for k, v in out[5].items()},
            "noise": drawn, "grads": grads}


def case_entry_rollout(mesh, job):
    """``make_distributed_rollout(..., with_params=True)`` of the entry
    point's GA3C-CADRL config on this rank's slice of the job's states, the
    weights broadcast from rank 0 (``entry.dryrun_rank``'s part (b))."""
    from gym_collision_avoidance_torch import entry

    kw = job["entry_rollout"]
    cfg, sc, _one, params = entry.build_batch(1, device=DEVICE)
    states = pmesh.shard_env_batch(convert.state_from_numpy(kw["states"], device=DEVICE), mesh)
    run = dist.make_distributed_rollout(cfg, kw["steps"], mesh, sc.active_policies,
                                        with_params=True)
    final, metrics = run(states, dist.replicate_global(params, mesh))
    return {"metrics": metrics, "states": convert.state_to_numpy(final)}


def case_count_all_reduce(mesh, job):
    """Every ``torch.distributed.all_reduce`` (calls, bytes) of one
    ``make_sharded_ppo`` iteration, of one ``AutoresetServer`` dispatch and
    ``episodes_completed`` call, and of one ``make_distributed_rollout``
    dispatch, recorded by wrapping the function."""
    import numpy as np

    from gym_collision_avoidance_torch.env.step import env_reset
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer
    from gym_collision_avoidance_torch.scenarios import presets, random_cases
    from gym_collision_avoidance_torch.train import ppo as tppo

    kw = job["count_all_reduce"]
    seen = []
    orig = torch.distributed.all_reduce

    def counted(tensor, *args, **kwargs):
        seen.append(tensor.numel() * tensor.element_size())
        return orig(tensor, *args, **kwargs)

    def record(fn):
        seen.clear()
        torch.distributed.all_reduce = counted
        try:
            fn()
        finally:
            torch.distributed.all_reduce = orig
        return {"calls": len(seen), "bytes": sum(seen)}

    step, init_fn, _ = tppo.make_sharded_ppo(tppo.PPOConfig(**kw["ppo"]), mesh)
    carry = init_fn(0)
    out = {"ppo": record(lambda: step(*carry, rng=torch.Generator().manual_seed(1)))}
    A, S = kw["num_agents"], kw["steps"]
    server = AutoresetServer(EnvConfig(dtype="float32", done_mode="evaluate"),
                             random_cases.scenario_pool(8, A, seed=0, side_length=4.0),
                             np.full(A, 1, np.int32), num_envs=kw["envs"],
                             steps_per_dispatch=S, mesh=mesh)
    out["serving_dispatch"] = record(server.dispatch)
    out["episodes_completed"] = record(server.episodes_completed)
    cfg = EnvConfig.evaluate(dtype="float32")
    sc = presets.circle_scenario(A, radius=4.0, agent_radius=0.4)
    base, _ = env_reset(sc.to_state(cfg, device=DEVICE), cfg)
    states = dist.host_local_batch(
        lambda idx: base.map(lambda x: x.repeat((len(idx),) + (1,) * (x.dim() - 1))),
        kw["envs"], mesh)
    run = dist.make_distributed_rollout(cfg, S, mesh, sc.active_policies)
    out["rollout_dispatch"] = record(lambda: run(states))
    return out


def case_slice(mesh, job):
    """``process_env_slice`` of the job's env counts: a slice or the error."""
    out = {}
    for n in job["slice"]:
        try:
            out[n] = dist.process_env_slice(n, mesh)
        except ValueError as err:
            out[n] = str(err)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("job")
    dist.add_rank_flags(ap)
    args = ap.parse_args()
    torch.set_num_threads(1)
    job = torch.load(args.job, weights_only=False)
    mesh = dist.join_rank_job(args, "gloo", "cpu")
    cases = {"server": case_server, "batched_step": case_batched_step,
             "rollout": case_rollout, "slice": case_slice, "entry_rollout": case_entry_rollout,
             "count_all_reduce": case_count_all_reduce}
    result = {"rank": mesh.rank, "size": mesh.size}
    for name in job["cases"]:
        if name.startswith("ppo"):
            result[name] = case_ppo(mesh, job, name)
        else:
            result[name] = cases[name](mesh, job)
    dist.save_rank_result(args, mesh, result)


if __name__ == "__main__":
    main()
