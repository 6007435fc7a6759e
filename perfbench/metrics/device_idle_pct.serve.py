"""The share of a step's untraced wall time in which the device ran
nothing: 1 - the traced busy time a step / the untraced wall time a step
of the window."""


def read(run):
    busy_per_step = run.trace.busy_s() / run.trace.steps
    return (1.0 - busy_per_step / (run.window_s / run.steps)) * 100.0
