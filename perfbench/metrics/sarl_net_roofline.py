"""SARL's value net's share of its roofline: the least time the net needs a
step on the chip's published peaks, the larger of its operations (the
reference module's ``flops``: 81 x ((A - 1) x 104 100 + 87 000) a row) at
the float32 peak and its bytes (each candidate row's A - 1 pairs of 13
features and its 6 ego features in, its value out, float32) at the HBM
peak, over the traced device time a step of the net's product kernels:
cuBLAS's and CUTLASS's (names with gemm, gemv, xmma or cutlass) and any
kernel named for the net (``sarl``).  Nothing when the trace holds none, or
for a configuration whose policy is not SARL."""

import re

from perfbench import flops, peaks, reference

NET = re.compile(r"gemm|gemv|xmma|cutlass|sarl", re.IGNORECASE)


def read(run):
    if run.config["reference"]["policy"] != "sarl":
        return None
    seconds = sum(e - s for name, s, e in run.trace.kernels if NET.search(name))
    peak = peaks.for_device(run.device_kind)
    if seconds <= 0 or peak is None:
        return None
    A = run.num_agents
    policy = reference.module("sarl")
    rows = run.num_envs * A * policy.NUM_CANDIDATES
    row_bytes = ((A - 1) * 13 + policy.SELF_DIM + 1) * 4
    bound = max(flops.policy_flops_per_step(run.config, run.num_envs) / peak["fp32_flops_per_s"],
                rows * row_bytes / peak["hbm_bytes_per_s"])
    return bound / (seconds / run.trace.steps) * 100.0
