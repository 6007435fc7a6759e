"""Regenerate the frozen 500-case test-suite pickles with the PyTorch
port's scenario generator (the counterpart of ``scripts/regenerate_suites.py``).

A fixed ``np.random`` seed, then ``num_test_cases`` cases of
``generate_rand_test_case_multi`` per agent count, written under the same
file names and ``vpref1.0_r0.1-0.1/`` prefix as the JAX script's; the
generator draws the JAX package's ``np.random`` stream, so the pickles are
its pickles byte for byte.  (The suites vendored in
``scenarios/test_cases/`` came from another generation and differ.)  Runs
on the host only: no device.

Usage: python scripts/regenerate_suites_torch.py [out_dir]
"""

from __future__ import annotations

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gym_collision_avoidance_torch.scenarios import random_cases  # noqa: E402


def main(out_dir="test_cases", seed=0, num_test_cases=500, agent_counts=(2, 3, 4),
         side_length=4, speed_bnds=(1.0, 1.0), radius_bnds=(0.1, 0.1)):
    os.makedirs(out_dir, exist_ok=True)
    for num_agents in agent_counts:
        np.random.seed(seed)
        cases = [random_cases.generate_rand_test_case_multi(
                     num_agents, side_length, list(speed_bnds), list(radius_bnds))
                 for _ in range(num_test_cases)]
        if tuple(speed_bnds) == (1.0, 1.0):
            prefix = f"vpref1.0_r{radius_bnds[0]}-{radius_bnds[1]}/"
            os.makedirs(os.path.join(out_dir, prefix.rstrip("/")), exist_ok=True)
        else:
            prefix = ""
        path = os.path.join(out_dir,
                            f"{prefix}{num_agents}_agents_{num_test_cases}_cases_seed{seed:03d}.p")
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        print(f"wrote {path}")


if __name__ == "__main__":
    main(*sys.argv[1:])
