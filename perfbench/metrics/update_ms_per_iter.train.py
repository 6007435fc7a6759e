"""Milliseconds an iteration of the trainer's own ``update`` phase (the
epochs of minibatch losses, autograd and optimizer steps), over the traced
iterations."""


def read(run):
    return run.timings["update"] / run.timed_iterations * 1e3 if run.timings else None
