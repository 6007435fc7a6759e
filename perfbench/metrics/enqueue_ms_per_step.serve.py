"""Host milliseconds a step spent inside ``dispatch()`` before the read,
over the untraced window: the benchmark's own span around the call."""


def read(run):
    return sum(run.enqueue_s) / run.steps * 1e3
