"""Frozen evaluation suites and formations (port of
:mod:`gym_collision_avoidance_tpu.scenarios.suites`, which imports no JAX;
this package keeps its own copy).

* :func:`preset_test_cases` -- the hard-coded small suites and the frozen
  500-case pickled suites per agent count (``envs/test_cases.py:593-918``;
  pickles at ``envs/test_cases/{N}_agents_500_cases.p``).  The pickles are
  frozen benchmark data, vendored byte-identical under this package's
  ``scenarios/test_cases/`` (a copy of the JAX package's, so the port needs
  nothing outside itself).
* :func:`formation_goals` -- the C/A/D/R/L letter formations
  (``envs/test_cases.py:425-492``).
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from gym_collision_avoidance_torch.scenarios.presets import (
    Scenario,
    from_cadrl_case,
    preset_two_agent_cases,
)

# Suite pickles are read from an explicit ``test_case_dir`` if given, else
# from the vendored package data.
VENDORED_TEST_CASE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_cases")


def _resolve_suite_file(relpath: str, test_case_dir: Optional[str]) -> str:
    """``relpath`` under ``test_case_dir``, else under the vendored data."""
    dirs = (test_case_dir,) if test_case_dir else (VENDORED_TEST_CASE_DIR,)
    for d in dirs:
        candidate = os.path.join(d, relpath)
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(f"suite pickle {relpath!r} not found under any of {dirs}")


def load_full_test_suite(
    num_agents: int,
    num_test_cases: int = 500,
    vpref_constraint: bool = False,
    radius_bounds=None,
    carrl: bool = False,
    seed: Optional[int] = None,
    test_case_dir: Optional[str] = None,
) -> List[np.ndarray]:
    """Load a frozen pickled suite (preset_testCases full_test_suite branch,
    envs/test_cases.py:601-624).  Returns a list of [A, 6] arrays."""
    pref_speed_string = (
        "vpref1.0_r{}-{}/".format(radius_bounds[0], radius_bounds[1])
        if vpref_constraint
        else ""
    )
    relpath = (
        f"{pref_speed_string}{num_agents}_agents_{num_test_cases}_cases.p"
    )
    if carrl:
        relpath = relpath[:-2] + "_carrl" + relpath[-2:]
    if seed is not None:
        relpath = relpath[:-2] + "_seed" + str(seed).zfill(3) + relpath[-2:]
    filename = _resolve_suite_file(relpath, test_case_dir)
    with open(filename, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _three_four_agent_cases() -> List[np.ndarray]:
    """Hard-coded 3/4-agent small suite (envs/test_cases.py:720-810)."""
    d = 3.0
    l1 = d * np.cos(np.pi / 6)
    l2 = d * np.sin(np.pi / 6)
    return [
        np.array([[0.0, d, 0.0, -d, 1.0, 0.5],
                  [l1, -l2, -l1, l2, 1.0, 0.5],
                  [-l1, -l2, l1, l2, 1.0, 0.5]]),
        np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.5],
                  [-3.0, 1.5, 3.0, 1.5, 1.0, 0.5],
                  [-3.0, -1.5, 3.0, -1.5, 1.0, 0.5]]),
        np.array([[3.0, 0.0, -3.0, 0.0, 1.0, 0.5],
                  [-3.0, 1.5, 3.0, 1.5, 1.0, 0.5],
                  [-3.0, -1.5, 3.0, -1.5, 1.0, 0.5]]),
        np.array([[3.0, 0.0, -3.0, 0.0, 1.0, 0.5],
                  [-3.0, 1.5, 3.0, -1.5, 1.0, 0.5],
                  [-3.0, -1.5, 3.0, 1.5, 1.0, 0.5]]),
        np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.3],
                  [3.0, 0.0, -3.0, 0.0, 1.0, 0.3],
                  [-3.0, -1.5, 3.0, -1.5, 1.0, 0.3],
                  [3.0, -1.5, -3.0, -1.5, 1.0, 0.3]]),
        np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.3],
                  [3.0, 0.0, -3.0, 0.0, 1.0, 0.3],
                  [-3.0, -3.0, 3.0, -3.0, 1.0, 0.3],
                  [3.0, -3.0, -3.0, -3.0, 1.0, 0.3]]),
        np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.5],
                  [0.0, -3.0, 0.0, 3.0, 1.0, 0.5],
                  [3.0, 0.0, -3.0, 0.0, 1.0, 0.5],
                  [0.0, 3.0, 0.0, -3.0, 1.0, 0.5]]),
        np.array([[-2.0, -1.5, 2.0, 1.5, 1.0, 0.5],
                  [-2.0, 1.5, 2.0, -1.5, 1.0, 0.5],
                  [-2.0, -4.0, 2.0, -4.0, 0.9, 0.35],
                  [2.0, -4.0, -2.0, -4.0, 0.85, 0.45]]),
        np.array([[-4.0, 0.0, 4.0, 0.0, 1.0, 0.4],
                  [-2.0, 0.0, 2.0, 0.0, 0.5, 0.4],
                  [-4.0, -4.0, 4.0, -4.0, 1.0, 0.4],
                  [-2.0, -4.0, 2.0, -4.0, 0.5, 0.4]]),
    ]


def gen_circle_test_case(num_agents: int, radius: float) -> np.ndarray:
    """envs/test_cases.py:900-911."""
    tc = np.zeros((num_agents, 6))
    for i in range(num_agents):
        tc[i, 4] = 1.0
        tc[i, 5] = 0.5
        theta_start = (2 * np.pi / num_agents) * i
        theta_end = theta_start + np.pi
        tc[i, 0] = radius * np.cos(theta_start)
        tc[i, 1] = radius * np.sin(theta_start)
        tc[i, 2] = radius * np.cos(theta_end)
        tc[i, 3] = radius * np.sin(theta_end)
    return tc


def preset_test_cases(num_agents: int, full_test_suite: bool = False,
                      **kwargs) -> List[np.ndarray]:
    """The small hard-coded suites (preset_testCases non-full branch,
    envs/test_cases.py:626-897) or the frozen 500-case pickles."""
    if full_test_suite:
        return load_full_test_suite(num_agents, **kwargs)
    if num_agents == 1:
        return [
            np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.3]]),
            np.array([[3.0 / 1.4, -3.0 / 1.4, -3.0 / 1.4, 3.0 / 1.4, 1.0, 0.3]]),
        ]
    if num_agents == 2:
        return preset_two_agent_cases() + [
            np.array([[-2.0, 0.0, 2.0, 0.0, 0.9, 0.35],
                      [2.0, 0.0, -2.0, 0.0, 0.85, 0.45]]),
            np.array([[-4.0, 0.0, 4.0, 0.0, 1.0, 0.4],
                      [-2.0, 0.0, 2.0, 0.0, 0.5, 0.4]]),
        ]
    if num_agents in (3, 4):
        return _three_four_agent_cases()
    if num_agents == 5:
        return [gen_circle_test_case(5, 4),
                np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.5],
                          [-3.0, 1.5, 3.0, 1.5, 1.0, 0.5],
                          [-3.0, -1.5, 3.0, -1.5, 1.0, 0.5],
                          [-3.0, 3.0, 3.0, 3.0, 1.0, 0.5],
                          [-3.0, -3.0, 3.0, -3.0, 1.0, 0.5]])]
    if num_agents == 6:
        return [gen_circle_test_case(6, 5),
                np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.5],
                          [-3.0, 1.5, 3.0, 1.5, 1.0, 0.5],
                          [-3.0, -1.5, 3.0, -1.5, 1.0, 0.5],
                          [-3.0, 3.0, 3.0, 3.0, 1.0, 0.5],
                          [-3.0, -3.0, 3.0, -3.0, 1.0, 0.5],
                          [-3.0, -4.5, 3.0, -4.5, 1.0, 0.5]]),
                np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.3],
                          [3.0, 0.0, -3.0, 0.0, 1.0, 0.3],
                          [-3.0, 0.7, 3.0, 0.7, 1.0, 0.3],
                          [3.0, 0.7, -3.0, 0.7, 1.0, 0.3],
                          [-3.0, -0.7, 3.0, -0.7, 1.0, 0.3],
                          [3.0, -0.7, -3.0, -0.7, 1.0, 0.3]]),
                np.array([[-3.0, 0.0, 3.0, 0.0, 1.0, 0.3],
                          [3.0, 0.0, -3.0, 0.0, 1.0, 0.3],
                          [-3.0, 1.0, 3.0, 1.0, 1.0, 0.3],
                          [3.0, 1.0, -3.0, 1.0, 1.0, 0.3],
                          [-3.0, -1.0, 3.0, -1.0, 1.0, 0.3],
                          [3.0, -1.0, -3.0, -1.0, 1.0, 0.3]])]
    if num_agents == 10:
        return [gen_circle_test_case(10, 5)]
    if num_agents == 20:
        return [gen_circle_test_case(20, 10)]
    raise ValueError(f"no preset suite for {num_agents} agents")


# C/A/D/R/L letter formations (envs/test_cases.py:426-476), 6 agents each.
FORMATION_LETTERS = {
    "A": 2 * np.array([[-1.5, 0.0], [1.5, 0.0], [0.75, 1.5],
                       [-0.75, 1.5], [0.0, 1.5], [0.0, 3.0]]),
    "C": 2 * np.array([[0.0, 0.0], [-0.5, 1.0], [-0.5, 2.0],
                       [0.0, 3.0], [1.5, 0.0], [1.5, 3.0]]),
    "L": 2 * np.array([[0.0, 0.0], [0.0, 1.0], [0.0, 2.0],
                       [0.0, 3.0], [0.75, 0.0], [1.5, 0.0]]),
    "D": 2 * np.array([[0.0, 0.0], [0.0, 1.5], [0.0, 3.0],
                       [1.5, 1.5], [1.2, 2.5], [1.2, 0.5]]),
    "R": 2 * np.array([[0.0, 0.0], [0.0, 1.5], [0.0, 3.0],
                       [1.3, 2.8], [1.2, 1.7], [1.7, 0.0]]),
}


def formation_goals(letter: str, num_agents: int = 6, rng=np.random) -> np.ndarray:
    """Shuffled letter-formation goals (``formation``,
    envs/test_cases.py:478-492): agents keep their positions and get a
    random slot of the letter as the new goal."""
    agent_inds = np.arange(num_agents)
    rng.shuffle(agent_inds)
    return FORMATION_LETTERS[letter][agent_inds]


def formation_scenario(current_pos: np.ndarray, letter: str,
                       radius: float = 0.5, pref_speed: float = 1.0,
                       policy: str = "GA3C_CADRL", rng=np.random) -> Scenario:
    """Next-episode scenario for the letter-formation demo
    (experiments/src/run_cadrl_formations.py): agents start where they are
    and navigate to the letter's slots."""
    A = current_pos.shape[0]
    goals = formation_goals(letter, A, rng)
    case = np.concatenate(
        [current_pos, goals, np.full((A, 1), pref_speed), np.full((A, 1), radius)],
        axis=1,
    )
    return from_cadrl_case(case, policy=policy)


def yaml_scenario(agents_yaml) -> Scenario:
    """YAML agent list -> Scenario (``yaml_to_agents``,
    envs/test_cases.py:1021-1041): each item maps a name to
    {start_x, start_y, goal_x, goal_y, policy, dynamics}; radius 0.5,
    pref_speed 1.0, heading 0.0 are fixed."""
    from gym_collision_avoidance_torch.core import dynamics as dyn
    from gym_collision_avoidance_torch.policies import registry as policies

    pos, goal, pids, dids = [], [], [], []
    for agent_item in agents_yaml:
        agent_dict = agent_item[list(agent_item.keys())[0]]
        pos.append([agent_dict["start_x"], agent_dict["start_y"]])
        goal.append([agent_dict["goal_x"], agent_dict["goal_y"]])
        pids.append(policies.POLICY_NAMES[agent_dict["policy"]])
        dids.append(dyn.DYNAMICS_NAMES[agent_dict["dynamics"]])
    A = len(pos)
    return Scenario(
        pos=np.array(pos, np.float64),
        goal=np.array(goal, np.float64),
        pref_speed=np.ones(A),
        radius=np.full(A, 0.5),
        heading=np.zeros(A),
        policy_id=np.array(pids, np.int32),
        dynamics_id=np.array(dids, np.int32),
    )
