"""DRL-Long's net's share of its roofline: the least time the net needs a
step on the chip's published peaks, the larger of its operations (the
reference module's ``flops``, 3 195 456 a row) at the float32 peak and its
bytes (each row's three frames of scan, goal and speed in, its mean action
out, float32) at the HBM peak, over the traced device time a step of the
net's convolution and product kernels: cuDNN's and cuBLAS's (names with
conv, fprop, cudnn, gemm, gemv, xmma or cutlass) and any kernel named for
the net (``drl_long``).  Nothing when the trace holds none, or for a
configuration whose policy is not DRL-Long."""

import re

from perfbench import flops, peaks
from perfbench.reference import sim

NET = re.compile(r"conv|fprop|cudnn|gemm|gemv|xmma|cutlass|drl_long", re.IGNORECASE)


def read(run):
    if run.config["reference"]["policy"] != "drl_long":
        return None
    seconds = sum(e - s for name, s, e in run.trace.kernels if NET.search(name))
    peak = peaks.for_device(run.device_kind)
    if seconds <= 0 or peak is None:
        return None
    rows = run.num_envs * run.num_agents
    cfg = sim.Config.from_env(run.config["env"], run.config.get("world"))
    row_bytes = (cfg.laserscan_num_past * cfg.laserscan_length + 2 + 2 + 2) * 4
    bound = max(flops.policy_flops_per_step(run.config, run.num_envs) / peak["fp32_flops_per_s"],
                rows * row_bytes / peak["hbm_bytes_per_s"])
    return bound / (seconds / run.trace.steps) * 100.0
