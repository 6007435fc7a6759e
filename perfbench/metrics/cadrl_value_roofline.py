"""The SA-CADRL value-net kernel's share of its roofline: the least time its
operations and bytes need on the chip's published peaks over its traced
device time a launch.

One launch a step computes the value net over every candidate row of the
step, R = E x A x 47: the operations are the policy net's a step
(``perfbench/flops.py``, the reference module's ``flops``), the bytes the
rows read and the values written, (31 + 1) x 4 a row in float32.  Nothing
when the trace holds no launch of the kernel (a program without it, or a
policy without this net)."""

from perfbench import flops, peaks, reference

KERNEL = "cadrl_value_gemm_kernel"
ROW_BYTES = (31 + 1) * 4


def read(run):
    launches = [e - s for name, s, e in run.trace.kernels if KERNEL in name]
    peak = peaks.for_device(run.device_kind)
    if not launches or peak is None:
        return None
    policy = reference.module(run.config["reference"]["policy"])
    rows = run.num_envs * run.config["num_agents"] * policy.NUM_CANDIDATES
    bound = max(flops.policy_flops_per_step(run.config, run.num_envs) / peak["fp32_flops_per_s"],
                rows * ROW_BYTES / peak["hbm_bytes_per_s"])
    return bound / (sum(launches) / len(launches)) * 100.0
