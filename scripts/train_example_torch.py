"""End-to-end RL training example on the PyTorch port (the counterpart of
``scripts/train_example.py``): a LearningPolicy agent trained with
REINFORCE against NonCooperative traffic, on the card.

The learner receives the flattened ego observation, emits a continuous
action in [0, 1]^2, and the env maps it to [speed, delta-heading]
(``LearningPolicy.external_action_to_action``).  One iteration is a
``horizon``-step rollout of every env from the start of its pool case, the
policy's log-likelihoods kept under autograd and the env stepped under
``torch.no_grad()`` (visited states are data, as the JAX example's
``stop_gradient`` makes them), then one Adam step (``train/optim.py``, in
optax's order) on the REINFORCE loss with reward-to-go weights and a
per-(case, step) baseline over the envs that share a pool case.

The draws are explicit: ``run(iters, generator=...)`` draws the initial
weights and each iteration's ``eps [T, E, 2]`` from a ``torch.Generator``,
or ``run(iters, init=(W1, b1, W2, b2), noise=eps [iters, T, E, 2])`` takes
them (the JAX example's draws, for a test).

Usage: python scripts/train_example_torch.py [--iters 30] [--envs 256]
    [--horizon 40] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HIDDEN = 64
LR = 3e-3
PARAM_NAMES = ("W1", "b1", "W2", "b2")


def case_baseline(rtg: torch.Tensor, num_cases: int) -> torch.Tensor:
    """``[T, E]``: for every step and env, the mean of ``rtg`` over the envs
    that run the same pool case (env ``i`` runs case ``i % num_cases``), the
    JAX example's ``((rtg @ onehot) / cnt) @ onehot.T``.  The envs are laid
    out ``[E / num_cases, num_cases]`` (zero-padded) and summed over the
    first axis: no scatter, so the sum's order is fixed on every device."""
    T, E = rtg.shape
    rows = -(-E // num_cases)
    padded = torch.nn.functional.pad(rtg, (0, rows * num_cases - E))
    sums = padded.reshape(T, rows, num_cases).sum(dim=1)                  # [T, P]
    counts = torch.bincount(torch.arange(E, device=rtg.device) % num_cases,
                            minlength=num_cases).to(rtg.dtype)
    mean = sums / torch.clamp_min(counts, 1.0)
    return mean.repeat(1, rows)[:, :E]


class Reinforce:
    """The pieces of the example for ``E`` envs and a ``T``-step horizon
    (:func:`build` returns its :meth:`run`)."""

    def __init__(self, E, T, seed=0, dtype="float32", num_agents=2, device=None):
        from gym_collision_avoidance_torch import EnvConfig
        from gym_collision_avoidance_torch.core import prng
        from gym_collision_avoidance_torch.core.device import resolve_device
        from gym_collision_avoidance_torch.env.autoreset import state_from_case
        from gym_collision_avoidance_torch.env.step import env_reset
        from gym_collision_avoidance_torch.obs import spec as obs_spec
        from gym_collision_avoidance_torch.policies import registry as P
        from gym_collision_avoidance_torch.scenarios import random_cases

        self.device = device = resolve_device(device)
        self.E, self.T, self.A, self.seed = E, T, num_agents, seed
        # reward_time_step is the reference's REWARD_TIME_STEP knob: without
        # it REINFORCE collapses to standing still
        self.cfg = EnvConfig(dtype=dtype, done_mode="learning", reward_time_step=-0.01)
        self.sensors, self.states_in_obs = ("other_agents_states",), obs_spec.DEFAULT_STATES_IN_OBS
        self.active = (P.LEARNING, P.NONCOOP)
        policy_id = np.array([P.LEARNING] + [P.NONCOOP] * (num_agents - 1), np.int32)
        # few cases, many envs a case: the baseline compares same-case rollouts
        self.num_cases = max(1, E // 8)
        pool = random_cases.scenario_pool(self.num_cases, num_agents, seed=seed, side_length=3.0)
        cases = pool[np.arange(E) % self.num_cases]
        # every rollout starts from these states (never changed in place)
        st = state_from_case(self.cfg, cases, policy_id, rng=prng.key(seed + 1), device=device)
        self.start = env_reset(st, self.cfg, self.sensors, self.states_in_obs)
        obs0 = self.start[1]
        # the JAX example flattens the obs dict's values in its pytree order,
        # which sorts the keys
        self.obs_keys = tuple(sorted(obs0))
        self.obs_dim = sum(math.prod(obs0[k].shape[2:]) for k in self.obs_keys)

    def flatten_ego(self, obs) -> torch.Tensor:
        """``[E, obs_dim]`` float32: agent 0's obs of every env."""
        return torch.cat([obs[k][:, 0].reshape(self.E, -1).to(torch.float32)
                          for k in self.obs_keys], dim=-1)

    def init_policy(self, generator: torch.Generator) -> dict:
        """He-scaled normal weights from ``generator``, zero biases."""
        def normal(shape, scale):
            return torch.randn(shape, generator=generator, device=generator.device) * scale
        p = {"W1": normal((self.obs_dim, HIDDEN), (2.0 / self.obs_dim) ** 0.5),
             "b1": torch.zeros(HIDDEN),
             "W2": normal((HIDDEN, 4), (2.0 / HIDDEN) ** 0.5),
             "b2": torch.zeros(4)}
        return {k: v.to(self.device).requires_grad_(True) for k, v in p.items()}

    @staticmethod
    def policy_dist(p, x):
        """The Gaussian's mean (in [0, 1]^2) and log std (in [-3, -0.7])."""
        from gym_collision_avoidance_torch.core import maths

        h = torch.relu(x @ p["W1"] + p["b1"])
        out = h @ p["W2"] + p["b2"]
        # log std starts near log(0.14): at 0 every sample would rail
        # against the action box's clip
        return torch.sigmoid(out[:, :2]), maths.clip(out[:, 2:] - 2.0, -3.0, -0.7)

    def rollout(self, p, eps):
        """One on-policy rollout with the noise ``eps [T, E, 2]``: the
        REINFORCE loss (with the autograd graph to ``p``) and the mean
        return (detached)."""
        from gym_collision_avoidance_torch.core import maths
        from gym_collision_avoidance_torch.env.batch import batched_env_step

        E, A, f32 = self.E, self.A, torch.float32
        states, obs = self.start
        dtype = states.pos.dtype
        rews, logps = [], []
        for t in range(self.T):
            mean, log_std = self.policy_dist(p, self.flatten_ego(obs))
            # not detached: the log-likelihood's gradient also flows through
            # the sample, as in the JAX example; its `/ exp(log_std)` is a
            # product with exp(-log_std) in the compiled step
            act = maths.clip(mean + torch.exp(log_std) * eps[t], 0.0, 1.0)
            logp = torch.sum(-0.5 * ((act - mean) * torch.exp(-log_std)) ** 2 - log_std, dim=-1)
            # actions after the learner's episode ended are frozen by the env
            logps.append(logp * (~states.is_done[:, 0]).to(f32))
            d_prev = states.dist_to_goal[:, 0].to(f32)
            with torch.no_grad():
                ext = torch.cat([act.detach().to(dtype)[:, None],
                                 torch.zeros((E, A - 1, 2), dtype=dtype, device=self.device)],
                                dim=1)
                states, obs, rew, _go, _info = batched_env_step(
                    states, ext, self.cfg, None, self.active, self.sensors, self.states_in_obs)
                # potential-based progress shaping (training side only)
                rews.append(rew[:, 0].to(f32)
                            + 0.3 * (d_prev - states.dist_to_goal[:, 0].to(f32)))
        rews, logps = torch.stack(rews), torch.stack(logps)          # [T, E]
        rtg = torch.flip(torch.cumsum(torch.flip(rews, [0]), dim=0), [0])
        adv = rtg - case_baseline(rtg, self.num_cases)
        loss = -torch.mean(torch.sum(logps * adv, dim=0))
        return loss, torch.mean(torch.sum(rews, dim=0))

    def train_step(self, p, opt_state, eps):
        """One iteration: ``(p, opt_state, loss, mean return, grads)``, the
        parameters updated in place."""
        from gym_collision_avoidance_torch.train import optim

        loss, ret = self.rollout(p, eps)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        updates, opt_state = optim.adam(grads, opt_state, LR)
        optim.apply_updates(p, updates)
        return p, opt_state, loss.detach(), ret, grads

    def run(self, iters, generator=None, init=None, noise=None):
        """``iters`` iterations; returns ``(params, [mean return of each])``.

        Draws from ``generator`` (default a CPU generator seeded with
        ``seed``) the weights unless ``init`` gives ``(W1, b1, W2, b2)``, and
        each iteration's ``eps [T, E, 2]`` unless ``noise`` gives all of them
        ``[iters, T, E, 2]``.
        """
        from gym_collision_avoidance_torch.train import optim

        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        if init is None:
            p = self.init_policy(generator)
        else:
            p = {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=self.device)
                 .requires_grad_(True) for k, v in zip(PARAM_NAMES, init)}
        opt_state = optim.init(p)
        rets = []
        for i in range(iters):
            if noise is None:
                eps = torch.randn((self.T, self.E, 2), generator=generator,
                                  device=generator.device).to(self.device)
            else:
                eps = torch.tensor(np.asarray(noise[i]), dtype=torch.float32,
                                      device=self.device)
            p, opt_state, _loss, ret, _grads = self.train_step(p, opt_state, eps)
            rets.append(float(ret))
            print(f"iter {i:3d}  mean return {rets[-1]:+.3f}", flush=True)
        return p, rets


def build(E, T, seed=0, dtype="float32", num_agents=2, device=None):
    """``run(iters, generator=None, init=None, noise=None) -> (params,
    returns)`` of :class:`Reinforce`; ``device=None`` means CUDA."""
    return Reinforce(E, T, seed, dtype, num_agents, device).run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    run = build(args.envs, args.horizon, device=args.device)
    _p, rets = run(args.iters)
    k = max(3, len(rets) // 5)
    print(f"first-{k} mean {np.mean(rets[:k]):+.3f} -> last-{k} mean {np.mean(rets[-k:]):+.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
