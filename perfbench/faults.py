"""Faults planted underneath the harness, for the tests and the readings
that show the comparison catches them (``perfbench/control.py --fault``).
The benchmark's own runs plant none.

Serving (``AutoresetServer.dispatch``): ``unchanged`` (the step returns its
state unchanged), ``half`` (half of the envs left unstepped), ``altered_state``
(every position moved by 1 cm where it is produced), ``altered_read`` (the
client's mean reward shifted by 1e-3); on a laser configuration
``altered_scan`` (every range of the scan history moved by one range
sample, 0.1 m) and ``one_scan_sample`` (one range of the first env's first
agent's newest scan moved by one range sample).  Training
(``PPOTrainer``): ``unchanged`` (``train_step`` returns its carry and
parameters unchanged), ``half_batch`` (each minibatch's loss over its first
half alone, the mean taken over the rest), ``altered_reward`` (every rollout
reward shifted by 0.01 where it is produced).
"""

from __future__ import annotations

import contextlib

import torch

SERVE = ("unchanged", "half", "altered_state", "altered_read")
# faults of state that only a laser configuration has
LASER = ("altered_scan", "one_scan_sample")
TRAIN = ("unchanged", "half_batch", "altered_reward")


def _serve(fault):
    from gym_collision_avoidance_torch.harness.serving import AutoresetServer

    orig = AutoresetServer.dispatch

    def dispatch(self):
        before, counters = self._states, self._counters
        out = orig(self)
        half = counters.shape[0] // 2
        if fault == "unchanged":
            self._states, self._counters = before, counters
        elif fault == "half":
            self._states = self._states.map(
                lambda new, old: torch.cat([new[:half], old[half:]]), before)
            self._counters = torch.cat([self._counters[:half], counters[half:]])
        elif fault == "altered_state":
            self._states = self._states.replace(pos=self._states.pos + 0.01)
        elif fault == "altered_read":
            out["mean_reward"] = out["mean_reward"] + 1e-3
        elif fault == "altered_scan":
            self._states = self._states.replace(
                laserscan_history=self._states.laserscan_history + 0.1)
        elif fault == "one_scan_sample":
            hist = self._states.laserscan_history.clone()
            hist[0, 0, 0, hist.shape[-1] // 2] += 0.1
            self._states = self._states.replace(laserscan_history=hist)
        else:
            raise ValueError(f"unknown serving fault {fault!r}")
        return out

    return AutoresetServer, "dispatch", dispatch


def _train(fault):
    from gym_collision_avoidance_torch.train.ppo import PPOTrainer, trainable_params

    if fault == "unchanged":
        orig = PPOTrainer.train_step

        def train_step(self, params, opt_state, states, counters, obs, **kw):
            kept = {k: v.detach().clone() for k, v in trainable_params(params).items()}
            *_, metrics = orig(self, params, opt_state, states, counters, obs, **kw)
            with torch.no_grad():
                for k, v in trainable_params(params).items():
                    v.copy_(kept[k])
            return params, opt_state, states, counters, obs, metrics

        return PPOTrainer, "train_step", train_step
    if fault == "half_batch":
        orig = PPOTrainer.loss_fn

        def loss_fn(self, params, batch):
            n = batch["x"].shape[0] // 2
            return orig(self, params, {k: v[:n] for k, v in batch.items()})

        return PPOTrainer, "loss_fn", loss_fn
    if fault == "altered_reward":
        orig = PPOTrainer.rollout_step

        def rollout_step(self, *args):
            *rest, sample = orig(self, *args)
            sample["reward"] = sample["reward"] + 0.01
            return (*rest, sample)

        return PPOTrainer, "rollout_step", rollout_step
    raise ValueError(f"unknown training fault {fault!r}")


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Within the block, the program carries ``fault`` (``kind`` is the
    traffic's kind, ``serve`` or ``train``)."""
    owner, name, broken = (_serve if kind == "serve" else _train)(fault)
    orig = owner.__dict__[name]
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, orig)
