"""CLI: the letter-formations demo on the PyTorch port (the counterpart of
``scripts/run_cadrl_formations.py``, which mirrors the reference's
experiments/src/run_cadrl_formations.py): 6 GA3C-CADRL agents spell
C-A-D-R-L, persisting across episodes, on the card (``--device cpu`` for the
CPU), with plots and optional GIFs (matplotlib, imageio).

Usage: python scripts/run_cadrl_formations_torch.py [--policy GA3C-CADRL-10]
    [--episodes 5] [--out results/cadrl_formations] [--animate] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", default="GA3C-CADRL-10")
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--out", default="results/cadrl_formations")
    ap.add_argument("--animate", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.harness import experiments

    out = experiments.run_formations_campaign(
        policy=args.policy, num_episodes=args.episodes, out_dir=args.out,
        animate=args.animate, device=resolve_device(args.device))
    for letter, stats, _traj in out:
        print(f"{letter}: {stats['outcome']} in {stats['steps']} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
