"""An iteration's share of the chip's float32 peak: the trained net's
operations (the rollout's forward over T + 1 steps, and each epoch's forward
and backward, the backward counted twice the forward; its reference
module's ``flops``) over the untraced wall time an iteration of the window,
on the host's clock."""

from perfbench import flops, peaks


def read(run):
    peak = peaks.for_device(run.device_kind)
    net = run.config["train"]["reference"]["net"]
    epochs = run.traffic["recipe"]["epochs"]
    rows = run.num_envs * (run.num_agents if run.config["train"]["self_play"] else 1)

    def fwd(n):
        return flops.net_flops(net, n, run.num_agents)

    per_iter = fwd(rows * (run.horizon + 1)) + 3 * epochs * fwd(rows * run.horizon)
    if peak is None or per_iter <= 0:
        return None
    return per_iter / (run.window_s / run.iterations * peak["fp32_flops_per_s"]) * 100.0
