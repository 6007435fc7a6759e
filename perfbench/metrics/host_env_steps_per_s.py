"""E x S x the dispatches completed in the untraced window, over its
seconds: the end-to-end rate, kept per layer in a cell whose pace is the
host's launch path, where it spreads too widely from run to run to bound."""


def read(run):
    return run.num_envs * run.steps / run.window_s
