"""The laser scan's share of its roofline: the least time the scan's bytes
need at the chip's published HBM peak (``perfbench/flops.py:k2_bytes``,
``perfbench/peaks.json``) over K2's traced device time a launch.  The bytes
are any scan's, not K2's design's, so the share is a floor.  Nothing when
the trace holds no launch of K2 (a world without the laser)."""

from perfbench import flops, peaks
from perfbench.reference import sim

KERNEL = "raymarch_kernel"


def read(run):
    launches = [e - s for name, s, e in run.trace.kernels if KERNEL in name]
    peak = peaks.for_device(run.device_kind)
    if not launches or peak is None:
        return None
    L = sim.Config.from_env(run.config["env"], run.config.get("world")).laserscan_length
    bound = flops.k2_bytes(run.num_envs, run.num_agents, L) / peak["hbm_bytes_per_s"]
    return bound / (sum(launches) / len(launches)) * 100.0
