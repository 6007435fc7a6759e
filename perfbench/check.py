"""The comparison that decides ``correct``.

The program's step is not a function the reference can replay from the
start: its argmax policies turn a rounding difference into another action,
and the trajectories part.  So the reference follows the program dispatch by
dispatch, from the program's own state before each snapshotted dispatch,
and judges what the program made of it:

* ``diverged_share``: the share of envs whose state or pool counter after
  the dispatch differs from the reference's (a flag, a counter or an index
  that differs, or a float off by more than ``DIVERGED`` relative), over all
  compared dispatches and the initial states;
* ``flip_margin``: over the envs that diverged, the largest of each env's
  smallest margin along the dispatch.  An env that parted by rounding has a
  margin of rounding size; one that parted for any other reason has a
  margin of the policy's or the world's own scale, or none (infinite).
  For a policy that takes an argmax (GA3C's, SA-CADRL's), the margin is
  the gap, in the reference's scores, between an agent's best action and
  its next best distinct one.  For a policy with no argmax, whose reference
  module defines ``margins`` (DRL-Long's), the action is continuous and an
  env parts only where the step turns a rounding into another branch: the
  margin is the distance, in metres (a heading's in radians), by which the
  nearest comparison of the step that sets a flag or a scan's range missed
  its threshold (:func:`perfbench.reference.sim.step_margins`), taken on
  each step's states before and after it (before the reset pick), for the
  envs that parted;
* ``float_err``: the largest error of any float the program made, over
  the envs that did not diverge: its state fields (relative), each step's
  ``mean_reward`` and ``obs_checksum`` as the client read them (beyond what
  the diverged envs can shift them, relative), and the policy outputs
  (GA3C's action probabilities, SA-CADRL's raw candidate values; the
  reference module's ``output_error``) that the program's function named
  by the configuration's ``program.policy_output`` returned in the
  dispatches after the window.  One number, because TF32 products leave the
  states and reads of the envs that kept their actions bitwise and move
  only the policy's outputs, while a fault in the env step moves only the
  former.

The policy outputs are compared only where that function was called once a
step (a path that calls it otherwise, or through a captured CUDA graph not
at all, bypasses it).  So that a bypass shows, the run reports how many
steps were compared, as ``policy_steps_compared`` beside the steps after
the window.  A step not compared leaves the policy net's outputs unjudged; its
actions still are, through ``diverged_share`` and ``flip_margin``, and the
env step, the reset pick and K1 through the states and reads.

A policy is judged by its reference module, ``perfbench/reference/<policy>
.py``, found by the name the configuration gives; a training recipe by
``train.reference``'s algorithm and net modules.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch

from perfbench import reference
from perfbench.reference import sim

ROOT = Path(__file__).resolve().parent.parent
# an env whose float state is off by more than this, relative, has parted
# from the reference (rounding differences stay near 1e-6; a different
# action moves an agent by centimetres or more)
DIVERGED = 1e-3
# the most a diverged env can shift one agent's reward in a step
REWARD_SPAN = 1.25


def margins(scores, ranked, done):
    """``[E]``: each env's smallest gap between an agent's best score and its
    next best distinct score, over the agents whose action was that argmax
    and who were not done."""
    top = scores.amax(dim=-1, keepdim=True)
    second = torch.where(scores < top, scores, torch.full_like(scores, -math.inf)).amax(dim=-1)
    m = (top[..., 0] - second).to(torch.float64)
    m = torch.where(ranked & ~done, m, torch.full_like(m, math.inf))
    return m.amin(dim=-1)


def compare_states(ref: dict, ref_counter, prog: dict, prog_counter):
    """``(diverged [E] bool, err [E] float64)`` of the program's states
    against the reference's, field by field; a field the program lacks, or
    of another shape, is a ``ValueError``."""
    E = ref["pos"].shape[0]
    dev = ref["pos"].device
    diverged = (prog_counter.to(dev).long() != ref_counter.long()).reshape(E)
    err = torch.zeros(E, dtype=torch.float64, device=dev)
    for name, r in ref.items():
        if name not in prog:
            raise ValueError(f"the program's state has no field {name!r}")
        p = prog[name].to(dev)
        if tuple(p.shape) != tuple(r.shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, reference {tuple(r.shape)}")
        if r.numel() == 0:
            continue
        if r.is_floating_point():
            p64, r64 = p.double(), r.double()
            d = (p64 - r64).abs() / (1.0 + r64.abs())
            d = torch.where(torch.isnan(p64) | torch.isnan(r64),
                            torch.where(torch.isnan(p64) & torch.isnan(r64),
                                        torch.zeros_like(d), torch.full_like(d, math.inf)), d)
            err = torch.maximum(err, d.reshape(E, -1).amax(dim=1))
        else:
            diverged |= (p != r).reshape(E, -1).any(dim=1)
    return diverged | (err > DIVERGED), err


def _policy_err(policy, prog_calls, ref_outs, keep):
    """``(error, steps)``: the largest error of the program's recorded policy
    outputs against the reference's over the envs of ``keep``, and the
    number of steps compared: all of them where the program's function was
    called once a step, else none."""
    if prog_calls is None or len(prog_calls) != len(ref_outs):
        return 0.0, 0
    worst = 0.0
    for p, r in zip(prog_calls, ref_outs):
        p = p.to(r.device).double().reshape(keep.shape[0], -1)
        r = r.double().reshape(keep.shape[0], -1)
        d = policy.output_error(p, r)
        d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
        if bool(keep.any()):
            worst = max(worst, float(d[keep].max()))
    return worst, len(ref_outs)


def _parted_margins(step_margins, trail, div, cfg):
    """``[E]``: the smallest of the policy module's step margins over the
    dispatch's steps (``trail``, each step's states before and after it),
    for the envs of ``div``; infinite elsewhere."""
    idx = div.nonzero()[:, 0]
    out = torch.full(div.shape, math.inf, dtype=torch.float64, device=div.device)
    for before, after in trail:
        m = step_margins({k: v[idx] for k, v in before.items()},
                         {k: v[idx] for k, v in after.items()}, cfg)
        out[idx] = torch.minimum(out[idx], m)
    return out


def judge_serving(config, pool, start, samples, steps, reads, device):
    """``(readings, compared)``: the readings of :mod:`perfbench.check`'s
    module docstring, from the program's initial states ``start`` and its
    snapshotted dispatches, and the policy steps compared (``{"steps":
    n, "of": m}``) of those after the window."""
    cfg = sim.Config.from_env(config["env"], config.get("world"))
    policy = reference.module(config["reference"]["policy"])
    weights = policy.load(str(ROOT / config["reference"]["weights"]), device)
    policy_id = np.full(config["num_agents"], config["policy_id"], np.int32)
    fresh, fresh_obs = sim.fresh_pool(cfg, pool, policy_id, device)
    E = start[0]["pos"].shape[0]

    # the start: the program's initial states are the pool's cases e % N
    first = torch.arange(E, dtype=torch.int32, device=device)
    init = sim.init_states(cfg, pool[np.arange(E) % len(pool)], policy_id, device)
    div, err = compare_states(init, first, start[0], start[1])
    n_div, n_env = int(div.sum()), E
    flip = math.inf if n_div else 0.0
    state_err = float(err[~div].max()) if bool((~div).any()) else 0.0
    reward_err = checksum_err = policy_err = 0.0
    compared = {"steps": 0, "of": 0}

    step_margins = getattr(policy, "margins", None)
    for sample in samples:
        s = {k: v.to(device) for k, v in sample["before"][0].items()}
        c = sample["before"][1].to(device)
        env_margin = torch.full((E,), math.inf, dtype=torch.float64, device=device)
        mean_reward, checksum, dmax, outs, trail = [], [], [], [], []
        for _ in range(steps):
            act, scores, out, ranked = policy.decide(weights, s, cfg)
            if step_margins is None:
                env_margin = torch.minimum(env_margin, margins(scores, ranked, s["is_done"]))
            before = s
            s, obs, r, game_over = sim.env_step(s, act, cfg)
            if step_margins is not None:
                # the margins of the envs that part are taken once the dispatch is judged
                trail.append(tuple({k: x[k] for k in sim.MARGIN_FIELDS} for x in (before, s)))
            s, obs, c = sim.reset_where_done(s, obs, c, game_over, fresh, fresh_obs)
            mean_reward.append(float(r.double().sum()) / (E * r.shape[1]))
            checksum.append(obs["dist_to_goal"][..., 0].double().sum(dim=0).cpu().numpy())
            dmax.append(float(obs["dist_to_goal"].abs().max()))
            outs.append(out)
        div, err = compare_states(s, c, sample["after"][0], sample["after"][1])
        nd = int(div.sum())
        n_div += nd
        n_env += E
        if nd:
            if step_margins is not None:
                env_margin = _parted_margins(step_margins, trail, div, cfg)
            flip = max(flip, float(env_margin[div].max()))
        if bool((~div).any()):
            state_err = max(state_err, float(err[~div].max()))
        if "mean_reward" in reads:
            allow = REWARD_SPAN * nd / E
            gap = np.abs(sample["read"]["mean_reward"] - np.array(mean_reward)) - allow
            reward_err = max(reward_err, float(np.max(np.nan_to_num(gap, nan=np.inf))))
        if "obs_checksum" in reads:
            ref_ck = np.stack(checksum)
            # a diverged env's agent reads at most twice the farthest distance off
            allow = 2.0 * nd * np.array(dmax)[:, None]
            gap = (np.abs(sample["read"]["obs_checksum"] - ref_ck) - allow) / (1.0 + np.abs(ref_ck))
            checksum_err = max(checksum_err, float(np.max(np.nan_to_num(gap, nan=np.inf))))
        if "policy" in sample:
            err, n = _policy_err(policy, sample["policy"], outs, ~div)
            policy_err = max(policy_err, err)
            compared["steps"] += n
            compared["of"] += steps
    readings = {"diverged_share": n_div / n_env, "flip_margin": flip,
                "float_err": max(state_err, reward_err, checksum_err, policy_err)}
    # JSON has no infinity: "no margin at all" and the like print as 1e300
    return {k: min(v, 1e300) for k, v in readings.items()}, compared


# ------------------------------------------------------------ training

# the recipe's fields that the program's PPOConfig and the reference share
PPO_FIELDS = ("gamma", "gae_lambda", "clip_eps", "epochs", "num_minibatches", "lr",
              "value_coef", "entropy_coef", "max_grad_norm", "shaping_coef")
# a leaf whose first gradient is under this share of the median leaf's moves
# by round-off alone, and is left out of the parameters' change
STILL_LEAF = 1e-3


def _leaf_gaps(prog: dict, ref: dict, leaves):
    """Worst leaf of ``|norm(prog) - norm(ref)|`` over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in leaves}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for k in leaves:
        p = float(torch.linalg.vector_norm(prog[k].to(ref[k].device).double()))
        gap = abs(p - norms[k]) / max(norms[k], median)
        worst = max(worst, math.inf if math.isnan(gap) else gap)
    return worst


def judge_training(config, recipe, pool, start, noises, losses, after_first, after, device):
    """``loss_gap`` (each reference iteration's loss against the program's,
    relative), ``grad_gap`` (the optimizer's first moment after the first
    iteration, by the worst leaf), ``change_gap`` (the parameters' change
    over the compared iterations, by the worst leaf), and ``diverged_share``
    (envs whose state or counter at the start or after the compared
    iterations differs from the reference's)."""
    tc = config["train"]
    ref_ppo = reference.module(tc["reference"]["algorithm"])
    net = reference.module(tc["reference"]["net"])
    cfg = sim.Config.from_env(tc["env"])
    A = config["num_agents"]
    policy_id = np.full(A, tc["learning_policy_id"], np.int32)
    E = start["counters"].shape[0]
    w = net.load_train(str(ROOT / tc["reference"]["weights"]), device)
    opt = ref_ppo.init_opt(w)
    fresh, fresh_obs = sim.fresh_pool(cfg, pool, policy_id, device)
    # the start: every env on case e % N, its PRNG words those of PRNGKey(1)
    s, obs = sim.sense(sim.init_states(cfg, pool[np.arange(E) % len(pool)], policy_id, device,
                                       rng=(0, 1)), cfg)
    c = torch.arange(E, dtype=torch.int32, device=device)
    div, _ = compare_states(s, c, start["states"], start["counters"])
    obs_div = torch.zeros_like(div)
    for k, v in obs.items():
        obs_div |= (start["obs"][k].to(device) != v).reshape(E, -1).any(dim=1)
    n_div = int((div | obs_div).sum())

    w0 = {k: v.clone() for k, v in w.items()}
    loss_gap, mu_first = 0.0, None
    for i, noise in enumerate(noises):
        s, c, obs, loss = ref_ppo.iteration(net, w, opt, s, c, obs, noise, recipe, cfg, fresh,
                                            fresh_obs)
        gap = abs(losses[i] - loss) / max(abs(loss), 1e-3)
        loss_gap = max(loss_gap, math.inf if math.isnan(gap) else gap)
        if i == 0:
            mu_first = {k: v.clone() for k, v in opt["mu"].items()}
    div, _ = compare_states(s, c, after["states"], after["counters"])
    n_div += int(div.sum())
    grad_gap = _leaf_gaps(after_first["mu"], mu_first, list(w))
    first_norms = {k: float(torch.linalg.vector_norm(mu_first[k].double())) for k in w}
    median = float(np.median(list(first_norms.values())))
    moving = [k for k in w if first_norms[k] >= STILL_LEAF * median]
    if len(moving) < len(w):
        print(f"perfbench: leaves left out of change_gap: {sorted(set(w) - set(moving))}",
              file=sys.stderr)
    change_gap = _leaf_gaps({k: after["params"][k].to(device) - start["params"][k].to(device)
                             for k in moving},
                            {k: w[k] - w0[k] for k in moving}, moving)
    readings = {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap, "diverged_share": n_div / (2 * E)}
    return {k: min(v, 1e300) for k, v in readings.items()}
