"""K1's share of its roofline: the least time its bytes and operations
need on the chip's published peaks (``perfbench/flops.py``,
``perfbench/peaks.json``) over its traced device time a launch."""

from perfbench import flops, peaks

KERNEL = "pairwise_kernel"


def read(run):
    launches = [e - s for name, s, e in run.trace.kernels if KERNEL in name]
    peak = peaks.for_device(run.device_kind)
    if not launches or peak is None:
        return None
    E, A = run.num_envs, run.num_agents
    bound = max(flops.k1_bytes(E, A) / peak["hbm_bytes_per_s"],
                flops.k1_flops(E, A) / peak["fp32_flops_per_s"])
    return bound / (sum(launches) / len(launches)) * 100.0
