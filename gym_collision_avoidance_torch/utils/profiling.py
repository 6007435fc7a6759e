"""Profiling and step timing (port of
:mod:`gym_collision_avoidance_tpu.utils.profiling`): a ``torch.profiler``
trace around a block, and steady-state step times with the card
synchronised."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block with ``torch.profiler`` (CPU activity, and CUDA activity
    when a card is present) and write a TensorBoard-readable trace
    (``*.pt.trace.json``) into ``log_dir`` at its end.  Yields the profiler,
    whose ``key_averages()`` summarise the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        _synchronize()


def time_step_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
                 **kwargs) -> Dict[str, float]:
    """Steady-state wall time of a step function: ``warmup`` calls, then
    ``iters`` timed calls between two synchronisations of the card.

    The function must return its next state as its first output (or as its
    only one), which is fed to the next call so that iterations chain.
    Returns ``{"mean_s", "steps_per_s"}``.
    """
    state, rest = args[0], args[1:]
    for _ in range(warmup):
        out = fn(state, *rest, **kwargs)
        state = out[0] if isinstance(out, tuple) else out
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(state, *rest, **kwargs)
        state = out[0] if isinstance(out, tuple) else out
    _synchronize()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "steps_per_s": 1.0 / dt}
