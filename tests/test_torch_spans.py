"""The port's step spans (``utils/profiling.py:span``) and the profile
script's view of them (``scripts/profile_torch_serving.py``), on the CPU.

Without a profiler a span enters no ``record_function`` and the served
values do not change with one; under ``profiling.trace`` each phase of each
step shows once, inside its parent span by time.  The benchmark's trace
reduction (``perfbench/trace.py``) leaves the spans' device-side ranges out
of the device's work, so its readings are those of a program without them.
"""

import importlib.util
import types
from pathlib import Path

import pytest
import torch

from gym_collision_avoidance_torch.harness import paths
from gym_collision_avoidance_torch.utils import profiling
from perfbench import trace as bench_trace

ROOT = Path(__file__).resolve().parent.parent
E, S = 8, 2
PHASES = ("gca.policy", "gca.dynamics", "gca.rewards", "gca.observe", "gca.reset")


def _server(name="ga3c4", num_envs=E, steps=S):
    return paths.serving_path(name, "cpu").server(num_envs=num_envs, steps_per_dispatch=steps,
                                                 device="cpu")


def _host_spans(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("gca.")]


def test_span_is_free_without_a_profiler(monkeypatch):
    """No profiler: no ``record_function`` is entered.  Under one, every
    span is, and two servers built alike serve the same bits either way."""
    entered = []
    record = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return record(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    plain, traced = _server(), _server()
    outs = [plain.dispatch() for _ in range(2)]
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        outs_traced = [traced.dispatch() for _ in range(2)]
    assert entered.count("gca.dispatch") == 2 and entered.count("gca.step") == 2 * S
    assert all(entered.count(p) == 2 * S for p in PHASES)
    for out, got in zip(outs, outs_traced):
        assert out.keys() == got.keys()
        assert all(torch.equal(out[k], got[k]) for k in out)
    for name, leaf in plain.states().items():
        assert torch.equal(leaf, getattr(traced.states(), name)), name
    assert torch.equal(plain.counters(), traced.counters())


def test_spans_nest_in_a_trace(tmp_path):
    """Two dispatches of S = 2 under ``profiling.trace``: 2 dispatch spans,
    4 step spans, 4 of each phase, each inside a span of its parent."""
    server = _server()
    server.dispatch()
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(2):
            server.dispatch()
    ranges = {}
    for e in _host_spans(prof):
        ranges.setdefault(e.name, []).append(e.time_range)
    assert {n: len(r) for n, r in ranges.items()} == {
        "gca.dispatch": 2, "gca.step": 2 * S, **{p: 2 * S for p in PHASES}}

    def inside(child, parents):
        return sum(p.start <= child.start and child.end <= p.end for p in parents) == 1

    assert all(inside(r, ranges["gca.dispatch"]) for r in ranges["gca.step"])
    for phase in PHASES:
        assert all(inside(r, ranges["gca.step"]) for r in ranges[phase]), phase


class _Event:
    """A kineto event as ``perfbench/trace.py`` reads it."""

    def __init__(self, name, device, start_us, end_us, annotation=False):
        self._name, self._device, self._annotation = name, device, annotation
        self._start, self._end = int(start_us * 1e3), int(end_us * 1e3)

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def is_user_annotation(self):
        return self._annotation

    def activity_type(self):
        return "gpu_user_annotation" if self._annotation else "kernel"


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_bench_reduction_ignores_the_spans():
    """The benchmark's reduction of a trace with the program's ``gca.*``
    ranges (on the host, and on the device as the profiler's annotations)
    equals its reduction of the same trace without them."""
    base, spans = [], []
    for t in (0.0, 100.0):
        base += [_Event("bench.dispatch", "CPU", t, t + 60), _Event("bench.read", "CPU", t + 60, t + 90),
                 _Event("kernel_a", "CUDA", t + 10, t + 30), _Event("kernel_b", "CUDA", t + 40, t + 80),
                 _Event("Memcpy DtoH", "CUDA", t + 85, t + 88)]
        spans += [_Event("gca.dispatch", "CPU", t + 1, t + 59), _Event("gca.step", "CPU", t + 2, t + 50),
                  _Event("gca.policy", "CPU", t + 3, t + 20),
                  _Event("gca.policy", "CUDA", t + 10, t + 30, annotation=True),
                  _Event("gca.step", "CUDA", t + 10, t + 80, annotation=True)]
    want = bench_trace.reduce(_prof(base), S)
    got = bench_trace.reduce(_prof(base + spans), S)
    assert got == want and got.breakdown() == want.breakdown()
    assert len(want.ops) == 3 and want.steps == S


def _script():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_serving", ROOT / "scripts" / "profile_torch_serving.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def test_profile_script_span_rows():
    """``scripts/profile_torch_serving.py:span_rows`` on a CPU trace: a row
    for each span, whose own host times add up to the dispatches' and whose
    device columns are empty (no device here)."""
    script = _script()
    server = _server()
    server.dispatch()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        server.dispatch()
    rows = script.span_rows(prof.profiler.kineto_results.events(), S)
    assert set(rows) == {"gca.dispatch", "gca.step", *PHASES}
    assert all(r["host_ms"] > 0 and r["device_ms"] == 0 and r["kernels"] == 0
               for r in rows.values())
    dispatch_ms = sum(e.time_range.elapsed_us() for e in _host_spans(prof)
                      if e.name == "gca.dispatch") / 1e3 / S
    assert sum(r["host_ms"] for r in rows.values()) == pytest.approx(dispatch_ms, rel=1e-6)
    assert script.device_ops(prof.events()) == []


def test_profile_script_reset_useful_share():
    """``profile_serving``'s ``reset_useful_pct`` is the episodes finished in
    its untraced dispatches over the pool rows the reset pick gathered there,
    one an env a step: a server built alike and run alike finishes as many."""
    script = _script()
    steps = 16
    report = script.profile_serving("main", num_envs=E, steps=steps, device="cpu")
    server = _server("main", num_envs=E, steps=steps)
    server.dispatch()
    before = server.episodes_completed()
    for _ in range(script.UNTRACED_DISPATCHES):
        server.dispatch()
    episodes = server.episodes_completed() - before
    assert 0 < episodes < E * steps * script.UNTRACED_DISPATCHES
    assert report["reset_useful_pct"] == pytest.approx(
        100 * episodes / (E * steps * script.UNTRACED_DISPATCHES), rel=1e-12)
    assert report["device_busy_ms_per_step"] == "not measured"
    assert set(report["spans_per_step"]) == {"gca.dispatch", "gca.step", *PHASES}
