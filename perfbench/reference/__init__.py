"""Plain references, one module a policy or training algorithm, found by the
name a configuration gives (``perfbench/configs/<config>.json``).

A policy module (``reference.policy``) has ``load(path, device)``,
``decide(weights, states, cfg)`` returning ``(actions, scores, outputs,
ranked)`` (``outputs`` None for a policy with no net), ``flops(rows,
num_agents)`` (0 for no net) and ``output_error(program, reference)``.  A
policy whose action is no argmax may define ``margins(before, after, cfg)
-> [E] float64``: each env's distance to a branch of one step, from the
states ``before`` it to those ``after`` it (the fields of
``sim.MARGIN_FIELDS``), which the judge reads in place of the argmax gap
(``perfbench/check.py``).  A trained net (``train.reference.net``) adds ``NUM_ACTIONS``,
``load_train``, ``train_net`` and ``to_actions``; the algorithm
(``train.reference.algorithm``) has ``init_opt`` and ``iteration``.
"""

from __future__ import annotations

import importlib


def module(name: str):
    """``perfbench/reference/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"not a reference module name: {name!r}")
    return importlib.import_module(f"perfbench.reference.{name}")
