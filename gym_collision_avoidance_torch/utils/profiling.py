"""Profiling (port of :mod:`gym_collision_avoidance_tpu.utils.profiling`): a
``torch.profiler`` trace around a block, and the named spans the port marks
its step's phases with.

The spans ride on the profiler: ``span(name)`` enters
``torch.profiler.record_function(name)`` only while a profiler records, so
the same trace holds the spans on the host and the device kernels they
launched, on one clock, and an untraced run pays one check a span.  The
serving path's spans, nested by time on the host thread:

- ``gca.dispatch``: ``AutoresetServer.dispatch``, its S steps, per-step sums
  and the dispatch's reduction;
- ``gca.step``: one step built by ``env.autoreset.make_autoreset_step``;
- ``gca.policy``, ``gca.dynamics``, ``gca.rewards``, ``gca.observe``: the
  action selection, dynamics, rewards (K1) and sensing of ``env.step.env_step``
  (whose other callers, the trainer's rollout and the suites, gain them too);
- ``gca.reset``: the reset pick of an auto-reset step;
- ``gca.sarl.lookahead``, ``gca.sarl.net``: inside ``gca.policy``, SARL's
  candidates, pair features and rewards, and its value net
  (``policies/sarl.py``).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks ``name`` in the trace while a profiler
    records (``torch.profiler.record_function``) and does nothing
    otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block with ``torch.profiler`` (CPU activity, and CUDA activity
    when a card is present) and write a TensorBoard-readable trace
    (``*.pt.trace.json``) into ``log_dir`` at its end.  Yields the profiler,
    whose ``key_averages()`` summarise the block, the spans of
    :func:`span` among them."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        _synchronize()
