"""Reduction of a ``torch.profiler`` trace to what the per-layer readers and
the result line use: the device operations and the benchmark's own spans
inside the traced stretch, the device's busy time, and the breakdown."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import List, Tuple

SPANS = ("bench.dispatch", "bench.read")
NOT_KERNELS = ("Memcpy", "Memset")
# kernel names are long template signatures; the breakdown keeps their heads
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    """Times in seconds from the stretch's start."""

    ops: List[Tuple[str, float, float]]      # device operations (name, start, end)
    spans: List[Tuple[str, float, float]]    # the benchmark's spans (name, start, end)
    window_s: float
    steps: int

    @property
    def kernels(self):
        return [op for op in self.ops if not op[0].startswith(NOT_KERNELS)]

    def busy_s(self) -> float:
        """Time in which some device operation ran (intervals merged)."""
        busy, end = 0.0, 0.0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device, each named by the benchmark span open when the
        gap began (``bench.host`` between spans)."""
        by_name = defaultdict(float)
        for name, s, e in self.ops:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], 0.0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                gaps.append((self.span_at(end), s - end))
            end = max(end, e)
        if self.window_s > end:
            gaps.append((self.span_at(end), self.window_s - end))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps[:top]]}

    def span_at(self, t: float) -> str:
        for name, s, e in self.spans:
            if s <= t < e:
                return name
        return "bench.host"


def _annotation(event) -> bool:
    """A range that a ``record_function`` marks on the device's timeline
    (the program's own, such as the trainer's ``ppo_rollout``): no work."""
    check = getattr(event, "is_user_annotation", None)
    return bool(check()) if check else "annotation" in str(event.activity_type())


def _times(event):
    if hasattr(event, "start_ns"):
        return event.start_ns() * 1e-9, event.end_ns() * 1e-9
    start = event.start_us() * 1e-6
    return start, start + event.duration_us() * 1e-6


def reduce(prof, steps_per_dispatch: int, skip: int = 1) -> Trace:
    """The stretch from the start of dispatch ``skip`` (the first ones pay
    the profiler's start-up) to the end of the last read."""
    events = prof.profiler.kineto_results.events()
    spans, ops = [], []
    for ev in events:
        start, end = _times(ev)
        if ev.name() in SPANS:
            # a span shows twice: on the host and as the device's annotation
            if "CUDA" not in str(ev.device_type()):
                spans.append((ev.name(), start, end))
        elif "CUDA" in str(ev.device_type()) and not _annotation(ev):
            ops.append((ev.name()[:NAME_CHARS], start, end))
    spans.sort(key=lambda s: s[1])
    dispatches = [s for s in spans if s[0] == "bench.dispatch"][skip:]
    if not dispatches:
        raise RuntimeError("the trace holds no dispatch span")
    t0 = dispatches[0][1]
    t1 = max(e for _, _, e in spans)
    ops = [(n, max(s, t0) - t0, min(e, t1) - t0) for n, s, e in ops if e > t0 and s < t1]
    spans = [(n, s - t0, e - t0) for n, s, e in spans if s >= t0]
    return Trace(ops=ops, spans=spans, window_s=t1 - t0,
                 steps=len(dispatches) * steps_per_dispatch)
