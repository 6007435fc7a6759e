"""The share of an iteration's untraced wall time in which the device ran
nothing: 1 - the traced busy time an iteration / the untraced wall time an
iteration of the window."""


def read(run):
    busy = run.trace.busy_s() / run.trace.steps
    return (1.0 - busy / (run.window_s / run.iterations)) * 100.0
