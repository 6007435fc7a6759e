"""CLI: the CADRL regression dataset on the PyTorch port (the counterpart of
``scripts/collect_regression_dataset.py``, which mirrors the reference's
experiments/src/collect_regression_dataset.py): (state, action, value)
triples pickled for train (seed 0) and test (seed 1), on the card
(``--device cpu`` for the CPU).

Usage: python scripts/collect_regression_dataset_torch.py [--train 100000]
    [--test 20000] [--agents 4] [--out datasets/regression] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", type=int, default=100000)
    ap.add_argument("--test", type=int, default=20000)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--out", default="datasets/regression")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.harness import datasets

    device = resolve_device(args.device)
    for mode, n in [("train", args.train), ("test", args.test)]:
        path = os.path.join(args.out,
                            f"{args.agents}_agents_cadrl_dataset_action_value_{mode}.p")
        datasets.collect_regression_dataset(n, num_agents=args.agents,
                                            seed=0 if mode == "train" else 1, out_path=path,
                                            device=device)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
