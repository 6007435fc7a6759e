"""The training driver: the port's ``PPOTrainer.train_step`` on one recipe.

Set-up builds one trainer and its carry (the recipe's warm-start net, a
fresh optimizer, every env at the start of its case of a pool drawn from the
seed) and drives it through its first ``reference_iterations`` iterations,
which are also the warm-up.  The window then calls ``train_step`` on the
same carry for ``--seconds``, and reads each iteration's metrics back, as a
training loop that logs does.  Every iteration's Gumbel noise and
minibatch permutations are the benchmark's own draws from the seed, handed
to the program.  After the window the plain reference
(``perfbench/reference/ppo.py``) runs the first iterations from the same
start and noise, and judges the program's losses, its optimizer's state
after the first iteration, its parameters' change and its env states
(``perfbench/check.py:judge_training``).
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from perfbench import check, reference, scenarios
from perfbench import trace as trace_mod
from perfbench.kinds.serve import _power_limit


def draw_noise(generator, recipe, streams, actions, device):
    """One iteration's inputs: Gumbel noise ``[T, B, actions]`` (the sample
    is ``argmax(logits + g)``) and one permutation of the ``B`` sample
    streams an epoch."""
    u = torch.rand((recipe["horizon"], streams, actions), generator=generator, device=device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    perm = torch.stack([torch.randperm(streams, generator=generator, device=device)
                        for _ in range(recipe["epochs"])])
    return {"gumbel": gumbel, "perm": perm}


def _clone_tree(x):
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    return x.detach().clone() if torch.is_tensor(x) else x


def _carry_snapshot(carry):
    params, opt, states, counters, obs = carry
    from gym_collision_avoidance_torch.train.ppo import trainable_params

    return {"params": _clone_tree(dict(trainable_params(params))), "opt": _clone_tree(opt),
            "states": {k: v.clone() for k, v in states.items()}, "counters": counters.clone(),
            "obs": _clone_tree(obs)}


def run(config, traffic, limits, seed, seconds, trace, device, t_start, control):
    from gym_collision_avoidance_torch.config import EnvConfig
    from gym_collision_avoidance_torch.harness.paths import TrainingPath
    from gym_collision_avoidance_torch.train.ppo import PPOConfig, PPOTrainer

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = device.type == "cuda"
    tc, recipe = config["train"], traffic["recipe"]
    A, E, T = int(config["num_agents"]), int(recipe["num_envs"]), int(recipe["horizon"])
    pool_seed, noise_seed = np.random.SeedSequence(seed).generate_state(2)
    pc = traffic["pool"]
    pool = scenarios.scenario_pool(pc["cases"], A, seed=int(pool_seed),
                                   side_length=pc["side_length"], speed_bnds=pc["speed_bnds"],
                                   radius_bnds=pc["radius_bnds"])
    ppo = PPOConfig(num_envs=E, horizon=T, num_agents=A, policy_arch=tc["policy_arch"],
                    self_play=tc["self_play"], **{k: recipe[k] for k in check.PPO_FIELDS})
    actions = reference.module(tc["reference"]["net"]).NUM_ACTIONS

    # ---- set-up: one trainer and carry, driven through the first iterations
    trainer = PPOTrainer(ppo, cfg=EnvConfig(**tc["env"]), pool=pool, device=device)
    carry = tuple(TrainingPath("bench", ppo, pool, tc.get("checkpoint")).init(trainer))
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif control:
        raise ValueError(f"unknown control {control!r}")
    generator = torch.Generator(device=device).manual_seed(int(noise_seed))
    streams = E * A if tc["self_play"] else E
    start = _carry_snapshot(carry)
    noises, losses, after_first = [], [], None
    for k in range(int(traffic["reference_iterations"])):
        noises.append(draw_noise(generator, recipe, streams, actions, device))
        *carry, metrics = trainer.train_step(*carry, noise=noises[-1])
        losses.append(float(metrics["loss"]))
        if k == 0:
            after_first = _clone_tree(carry[1])
    after = _carry_snapshot(carry)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window
    iteration_s, enqueue_s, failed = [], [], 0
    w0 = time.perf_counter()
    while True:
        noise = draw_noise(generator, recipe, streams, actions, device)
        t0 = time.perf_counter()
        *carry, metrics = trainer.train_step(*carry, noise=noise)
        t1 = time.perf_counter()
        got = torch.stack([v.reshape(()) for v in metrics.values()]).cpu()
        t2 = time.perf_counter()
        iteration_s.append(t2 - t0)
        enqueue_s.append(t1 - t0)
        failed += not bool(torch.isfinite(got).all())
        if t2 - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # ---- the traced stretch: the trainer's own phase timings under the profiler
    tr, timings, traced = None, {}, int(traffic["trace_iterations"])
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            for i in range(traced):
                noise = draw_noise(generator, recipe, streams, actions, device)
                with record_function("bench.dispatch"):
                    *carry, metrics = trainer.train_step(*carry, noise=noise,
                                                         timings=timings if i else None)
                with record_function("bench.read"):
                    torch.stack([v.reshape(()) for v in metrics.values()]).cpu()
        tr = trace_mod.reduce(prof, 1)
    del trainer, carry
    if on_card:
        torch.cuda.empty_cache()

    # ---- the reference judges
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = check.judge_training(config, recipe, pool, start, noises, losses, after_first,
                                    after, device)
    correct = all(readings[k] <= limits[k] for k in limits) and failed == 0
    result = {
        "correct": bool(correct), "attempted": len(iteration_s), "failed": failed,
        "e2e": {"train_env_steps_per_s": E * T * len(iteration_s) / window_s,
                "setup_s": setup_s},
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak),
                   "power_limit": _power_limit() if on_card else "none"},
        "check": {k: {"value": readings[k], "limit": limits[k]} for k in limits},
    }
    if trace:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
        result["run"] = types.SimpleNamespace(
            config=config, traffic=traffic, num_envs=E, num_agents=A, horizon=T,
            iteration_s=iteration_s, enqueue_s=enqueue_s, window_s=window_s,
            iterations=len(iteration_s), trace=tr, timings=timings, timed_iterations=traced - 1,
            device_kind=result["device"]["kind"])
    return result
