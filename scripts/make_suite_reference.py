"""Write the JAX package's per-episode outcomes of the frozen evaluation
suites, the reference the PyTorch port's suite runs are held to.

Runs ``gym_collision_avoidance_tpu.harness.experiments.run_full_test_suite``
on the CPU, float32, ``EnvConfig.evaluate``, with JAX's x64 mode off (as
``scripts/run_full_test_suite.py`` leaves it), over {2, 3, 4} agents x
{CADRL, RVO, GA3C-CADRL-10} x the first 500 cases of each frozen suite, and
writes ``tests/data/torch_suite_jax_outcomes.json``: for each cell the
per-episode ``outcome`` and ``steps`` and the ``summarize_suite`` row, plus
the jax version and the x64 flag.  This is the only script of the port's
records that imports JAX; ``chip_smoke.py`` and
``scripts/run_full_test_suite_torch.py --reference`` read the JSON.

Usage::

    python scripts/make_suite_reference.py [--agents 2 3 4]
        [--policies CADRL RVO GA3C-CADRL-10] [--cases 500] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_suite_jax_outcomes.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", nargs="+", type=int, default=[2, 3, 4])
    ap.add_argument("--policies", nargs="+", default=["CADRL", "RVO", "GA3C-CADRL-10"])
    ap.add_argument("--cases", type=int, default=500)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from gym_collision_avoidance_tpu.config import EnvConfig
    from gym_collision_avoidance_tpu.harness import experiments

    cfg = EnvConfig.evaluate(dtype="float32")
    cells = []
    for num_agents in args.agents:
        for policy in args.policies:
            results = experiments.run_full_test_suite(
                policies_to_test=(policy,), num_agents_to_test=(num_agents,),
                num_test_cases=args.cases, cfg=cfg)
            df = results[(num_agents, policy)]
            row = experiments.summarize_suite(results).iloc[0].to_dict()
            summary = {k: (v if isinstance(v, str) else float(v)) for k, v in row.items()
                       if k not in ("num_agents", "policy")}
            cells.append({"num_agents": num_agents, "policy": policy, "cases": len(df),
                          "outcome": [str(o) for o in df["outcome"]],
                          "steps": [int(s) for s in df["steps"]],
                          "summary": summary})
            print(json.dumps({"num_agents": num_agents, "policy": policy, **summary}),
                  flush=True)
    doc = {"generator": "scripts/make_suite_reference.py",
           "package": "gym_collision_avoidance_tpu", "jax_version": jax.__version__,
           "x64": bool(jax.config.jax_enable_x64), "platform": "cpu", "dtype": "float32",
           "config": "EnvConfig.evaluate", "cells": cells}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
