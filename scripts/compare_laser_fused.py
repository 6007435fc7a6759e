#!/usr/bin/env python3
"""Time this checkout's K3 (``csrc/laser_fused.cu``) against another version
of the same source, on one CUDA card, on the same inputs.

Both sources must keep K3's C interface.  The other one is built with the
same ``nvcc`` flags into ``gym_collision_avoidance_torch/build/``; the
script captures K3's arguments from the fast laser route at
``chip_smoke.py``'s laser shape (256 envs x 20 agents x 512 beams, float32)
on the empty map, on map 002 and on the route without wedge culling
(B = 1), holds both kernels bitwise against the plain version, and times
them in the order other, this, this, other (CUDA-graph replay, CUDA
events).  It prints one JSON line, with each version's registers and
spills as ``ptxas -v`` reports them and the card's ``nvidia-smi`` name and
power limit.  Run from the root of a checkout:

    python3 scripts/compare_laser_fused.py --other PATH/TO/laser_fused.cu
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_other(path, build):
    """Build ``path`` with the port's flags; its float32 entry point."""
    src = open(path, "rb").read()
    digest = hashlib.sha256(src + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = build.BUILD_DIR / f"libother_laser_fused-{digest}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), path], check=True)
    return ctypes.CDLL(str(lib)).laser_fused_f32


def ptxas_report(path, build):
    """``{dtype: {"registers", "spill_stores", "spill_loads"}}`` of the
    kernel in ``path``, from ``ptxas -v`` with the port's flags."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               os.path.join(tmp, "lib.so"), path],
                              capture_output=True, text=True, check=True)
    report, dtype = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '.*laser_fused_kernelI([fd])E", line)
        if entry:
            dtype = "float32" if entry.group(1) == "f" else "float64"
            report[dtype] = {}
        elif dtype and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                       line)):
            report[dtype].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif dtype and (m := re.search(r"Used (\d+) registers", line)):
            report[dtype]["registers"] = int(m.group(1))
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other laser_fused.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.ops import build, laser_fused

    this = laser_fused.KERNEL.func(torch.float32)
    other = build_other(args.other, build)
    other.argtypes, other.restype = this.argtypes, this.restype
    band = smoke.band_model("laser_fused")

    def run_with(fn, call):
        laser_fused.KERNEL.funcs[torch.float32] = fn
        return laser_fused.beam_compacted_cuda(*call)

    fast = paths.laser_config(True)
    b1 = paths.laser_config(True, laserscan_num_candidate_discs=None)
    shapes = {"empty": (fast, None, 16), "map_002": (fast, "002", 25), "b1": (b1, None, 26)}
    result = {}
    try:
        for key, (cfg, map_name, seed) in shapes.items():
            _static, cells = paths.map_inputs(cfg, smoke.DEVICE, map_name,
                                              pad=16 if map_name else 0)
            state = smoke.laser_states(cfg, smoke.E_LASER, seed, smoke.DEVICE)
            call = band.fused_args(cfg, state, cells)
            ref, ref_ovf = laser_fused.beam_compacted_plain(*call)
            for name, fn in (("other", other), ("this", this)):
                out, ovf = run_with(fn, call)
                torch.cuda.synchronize()
                smoke.check(smoke.bitwise_equal(out, ref) and torch.equal(ovf, ref_ovf),
                            f"{name} K3 differs from the plain version on {key}")
            times = {"other": [], "this": []}
            for name, fn in (("other", other), ("this", this), ("this", this), ("other", other)):
                times[name].append(smoke.graph_ms(lambda: run_with(fn, call)))
            result[key] = {"S": call[6].shape[-1], "B": call[6].shape[2], **times}
    finally:
        laser_fused.KERNEL.funcs[torch.float32] = this
    ptxas = {"other": ptxas_report(args.other, build),
             "this": ptxas_report(str(build.CSRC_DIR / "laser_fused.cu"), build)}
    print(json.dumps({"compare_laser_fused": result, "other": args.other, "ptxas": ptxas,
                      "device": smoke.nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
