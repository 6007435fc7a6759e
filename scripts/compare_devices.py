#!/usr/bin/env python3
"""Which PyTorch op makes a policy's output differ between the CUDA card and
the CPU.

Builds mid-episode float32 states of one of the port's paths on the card
(each env on its own pool case), then runs the policy once on the card under
a dispatch mode that replays every aten op on the CPU with copies of the
same inputs and compares the outputs bitwise.  An op whose replay differs
computes something else on the two devices; if no op differs, the whole
computation is bitwise equal by induction.  Prints one JSON line: for each
(op, source line) that differed, its calls, the calls that differed, the
largest difference and the index of its first differing call, in call
order, plus the card's ``nvidia-smi`` name and power limit.

    python3 scripts/compare_devices.py [--path orca4|cadrl4|drl2] [--num-envs N]
        [--out results/compare_devices.json]

The paths are those of ``gym_collision_avoidance_torch/harness/paths.py``,
with their default env counts: ``orca4`` replays ``ops.orca.orca_solve``
(4 RVO agents), ``cadrl4`` the SA-CADRL candidate values (4 agents) and
``drl2`` the DRL-Long kernel and the ORCA solve of its RVO agent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PACKAGE = "gym_collision_avoidance_torch"
# outputs that hold no defined values
_UNDEFINED = ("empty", "new_empty", "empty_like", "empty_strided", "set_")


def _where():
    """``file:line`` of the innermost frame of the package."""
    for frame in reversed(traceback.extract_stack()):
        if _PACKAGE in frame.filename:
            return f"{frame.filename.split(_PACKAGE)[-1].lstrip('/')}:{frame.lineno}"
    return "?"


def _to_cpu(x):
    """A CPU copy with the same storage offset and strides: the CPU kernels
    take other code paths (vectorised or not) for other layouts."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach()
    return torch.empty(0, dtype=x.dtype).set_(x.untyped_storage().cpu(), x.storage_offset(),
                                              x.size(), x.stride())


def _bitwise(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.contiguous(), b.contiguous()
    if a.is_floating_point():
        itype = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(itype), b.view(itype))
    return torch.equal(a, b)


class ReplayOnCPU(TorchDispatchMode):
    """Run each op on its own device and again on the CPU; record the ops
    whose outputs are not bitwise equal."""

    def __init__(self):
        super().__init__()
        self.calls = 0
        self.rows = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket.__name__)
        cpu_args, cpu_kwargs = tree_map(_to_cpu, args), tree_map(_to_cpu, kwargs)
        if "device" in cpu_kwargs:
            cpu_kwargs["device"] = torch.device("cpu")
        out = func(*args, **kwargs)
        if name in _UNDEFINED:
            return out
        self.calls += 1
        key = (name, _where())
        row = self.rows.setdefault(key, {"op": name, "where": key[1], "calls": 0,
                                         "differing_calls": 0, "max_abs_diff": 0.0,
                                         "first_differing_call": None})
        row["calls"] += 1
        try:
            ref = func(*cpu_args, **cpu_kwargs)
        except Exception as exc:                   # noqa: BLE001 - reported, not hidden
            row["replay_failed"] = repr(exc)[:120]
            return out
        got, _ = tree_flatten(out)
        want, _ = tree_flatten(ref)
        differ, worst = False, 0.0
        for g, w in zip(got, want):
            if isinstance(g, torch.Tensor) and isinstance(w, torch.Tensor):
                g = g.detach().cpu()
                if not _bitwise(g, w):
                    differ = True
                    if g.is_floating_point() and g.shape == w.shape and g.numel():
                        d = (g.double() - w.double()).abs()
                        d = d[~torch.isnan(d)]
                        worst = max(worst, float(d.max()) if d.numel() else float("nan"))
            elif g != w:
                differ = True
        if differ:
            row["differing_calls"] += 1
            row["max_abs_diff"] = max(row["max_abs_diff"], worst)
            if row["first_differing_call"] is None:
                row["first_differing_call"] = self.calls
        return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("orca4", "cadrl4", "drl2"), default="orca4")
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.ops import orca
    from gym_collision_avoidance_torch.policies import cadrl, drl_long, rvo

    path = paths.serving_path(args.path)
    E = args.num_envs or path.num_envs
    cfg, params = path.cfg, path.params
    state, _cases = paths.mid_episode_states(path, E, 15 if args.path != "orca4" else 12)
    if args.path == "orca4":
        run = lambda: orca.orca_solve(*rvo.orca_inputs(state, cfg, None))  # noqa: E731
    elif args.path == "cadrl4":
        run = lambda: cadrl.cadrl_values(state, cfg, params)[0]  # noqa: E731
    else:
        run = lambda: (drl_long.drl_long_kernel(state, cfg, params),  # noqa: E731
                       orca.orca_solve(*rvo.orca_inputs(state, cfg, None)))
    torch.cuda.synchronize()
    mode = ReplayOnCPU()
    with mode:
        run()
    torch.cuda.synchronize()
    differing = sorted((r for r in mode.rows.values() if r["differing_calls"]
                        or "replay_failed" in r), key=lambda r: r["first_differing_call"] or 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    line = {"compare_devices": {"device": smi, "path": args.path, "num_envs": E,
                                "ops_replayed": mode.calls,
                                "op_sites": len(mode.rows), "differing": differing}}
    print(json.dumps(line))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
