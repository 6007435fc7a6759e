"""Milliseconds an iteration of the trainer's own ``rollout`` phase
(``PPOTrainer.train_step(timings=...)``, which synchronises at each phase
boundary), over the traced iterations."""


def read(run):
    return run.timings["rollout"] / run.timed_iterations * 1e3 if run.timings else None
