"""Minimum working example on the PyTorch port (the counterpart of
``scripts/example.py``, which mirrors the reference's
experiments/src/example.py): 2 agents, one driven by external actions and
one running GA3C-CADRL, through the gym API (``env/gymapi.py``) on the card
(``--device cpu`` for the CPU), with a trajectory plot saved at the end
(needs matplotlib).

Usage: python scripts/example_torch.py [--device cuda|cpu] [--out results/example]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "example"),
                    help="where the trajectory plot goes")
    args = ap.parse_args(argv)

    import numpy as np

    from gym_collision_avoidance_torch import EnvConfig
    from gym_collision_avoidance_torch.env.gymapi import CollisionAvoidanceEnv
    from gym_collision_avoidance_torch.models import ga3c_cadrl
    from gym_collision_avoidance_torch.policies import registry as P
    from gym_collision_avoidance_torch.scenarios import presets

    cfg = EnvConfig.evaluate(dtype="float32", max_num_other_agents_observed=19,
                             agent_sorting_method="closest_last")
    sc = presets.two_agents_swap()
    sc.policy_id = np.array([P.LEARNING, P.GA3C_CADRL], np.int32)
    env = CollisionAvoidanceEnv(cfg=cfg, scenario=sc,
                                params={"ga3c_cadrl": ga3c_cadrl.load_params(device=args.device)},
                                device=args.device)
    env.set_plot_save_dir(args.out)

    env.reset()
    for _ in range(100):
        # the external agent gets its action from this script
        _obs, _rewards, terminated, _truncated, _info = env.step({0: np.array([1.0, 0.5])})
        if terminated:
            print("All agents finished!")
            break
    print(f"saved {env.plot_episode()}")
    print("Experiment over.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
