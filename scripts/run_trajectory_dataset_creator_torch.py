"""CLI: the RVO trajectory dataset on the PyTorch port (the counterpart of
``scripts/run_trajectory_dataset_creator.py``, which mirrors the
reference's experiments/src/run_trajectory_dataset_creator.py), on the card
(``--device cpu`` for the CPU).

Usage: python scripts/run_trajectory_dataset_creator_torch.py [--trajs 100]
    [--out datasets/trajs/rvo_trajs.p] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trajs", type=int, default=100)
    ap.add_argument("--out", default="datasets/trajs/rvo_trajs.p")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.harness import datasets

    trajs = datasets.collect_trajectory_dataset(num_trajs=args.trajs, out_path=args.out,
                                                device=resolve_device(args.device))
    print(f"wrote {args.out} ({len(trajs)} trajectories)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
