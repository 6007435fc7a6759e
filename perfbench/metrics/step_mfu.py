"""The whole step's share of the chip's float32 peak: the policy net's
operations a step (its reference module's ``flops``) over the untraced wall
time a step of the window, on the host's clock.  Nothing for a policy with
no net."""

from perfbench import flops, peaks


def read(run):
    peak = peaks.for_device(run.device_kind)
    per_step = flops.policy_flops_per_step(run.config, run.num_envs)
    if peak is None or per_step <= 0:
        return None
    return per_step / (run.window_s / run.steps * peak["fp32_flops_per_s"]) * 100.0
