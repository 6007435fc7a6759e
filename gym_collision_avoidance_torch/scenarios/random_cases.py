"""Host-side random scenario generation.

A verbatim copy of ``gym_collision_avoidance_tpu/scenarios/random_cases.py``
(pure numpy; the port keeps its own copy so it never imports the JAX
package).  ``tests/test_torch_scenarios.py`` holds the pools bitwise equal.

Faithful reimplementation of the reference's legacy CADRL test-case
generator (``envs/policies/CADRL/scripts/multi/gen_rand_testcases.py``) and
the ``get_testcase_random`` / ``cadrl_test_case_to_agents`` glue
(``envs/test_cases.py:212-253, 495-590``).

Scenario sampling is inherently data-dependent rejection sampling, so it
stays host-side numpy (resets are rare; device upload is cheap) — and it
deliberately consumes the *same ``np.random`` call sequence* as the
reference so seeded runs produce identical scenario streams.  Pre-generate
pools with :func:`scenario_pool` for in-graph auto-reset.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gym_collision_avoidance_torch.core import dynamics as dyn
from gym_collision_avoidance_torch.policies import registry as policies
from gym_collision_avoidance_torch.scenarios.presets import Scenario

GETTING_CLOSE_RANGE = 0.2  # CADRL global_var.py:8


def _dist_point_to_segment(p1, p2, p3):
    """gen_rand_testcases.distPointToSegment (:91-108)."""
    d = p2 - p1
    if np.linalg.norm(d) < 1e-5:
        u = 0.0
    else:
        u = np.dot(d, (p3 - p1)) / (np.linalg.norm(d) ** 2.0)
    u = max(0.0, min(u, 1.0))
    inter = p1 + u * d
    return np.linalg.norm(p3 - inter)


def _dist_between_segs(x1, x2, y1, y2):
    """gen_rand_testcases.find_dist_between_segs (:54-88), single pair."""
    x2 = x2.reshape((1, 2))
    y2 = y2.reshape((1, 2))
    end_dist = np.linalg.norm(x2 - y2, axis=1)
    critical_dist = end_dist.copy()
    z_bar = (x2 - x1) - (y2 - y1)
    inds = np.where(np.linalg.norm(z_bar, axis=1) > 0)[0]
    if len(inds):
        t_bar = -np.sum((x1 - y1) * z_bar[inds, :], axis=1) / np.sum(
            z_bar[inds, :] * z_bar[inds, :], axis=1
        )
        t_rep = np.tile(t_bar, (2, 1)).transpose()
        dist_bar = np.linalg.norm(
            x1 + (x2[inds, :] - x1) * t_rep - y1 - (y2[inds, :] - y1) * t_rep, axis=1
        )
        inds2 = np.where((t_bar > 0) & (t_bar < 1.0))
        critical_dist[inds[inds2]] = dist_bar[inds2]
    return float(np.amin(np.vstack((end_dist, critical_dist)), axis=0)[0])


def _if_permit_straight_line(x1, x2, s1, y1, y2, s2, radius):
    """"Interestingness" filter: reject scenarios solvable by straight
    lines (gen_rand_testcases.py:425-444)."""
    t1 = np.linalg.norm(x2 - x1) / s1
    t2 = np.linalg.norm(y2 - y1) / s2
    if t1 < t2:
        x_crit = x2
        y_crit = y1 + t1 * (y2 - y1) / t2
        if _dist_point_to_segment(y_crit, y2, x_crit) < radius:
            return False
    else:
        x_crit = x1 + t2 * (x2 - x1) / t1
        y_crit = y2
        if _dist_point_to_segment(x_crit, x2, y_crit) < radius:
            return False
    start_dist = np.linalg.norm(x1 - y1)
    end_dist = np.linalg.norm(x_crit - y_crit)
    mid_dist = _dist_between_segs(x1, x_crit, y1, y_crit)
    return min(start_dist, end_dist, mid_dist) >= radius


def _sample_radius_speed(test_case, i, speed_bnds, radius_bnds, rng):
    test_case[i, 5] = (radius_bnds[1] - radius_bnds[0]) * rng.rand() + radius_bnds[0]
    s1 = (speed_bnds[1] - speed_bnds[0]) * rng.rand() + speed_bnds[0]
    s2 = (speed_bnds[1] - speed_bnds[0]) * rng.rand() + speed_bnds[0]
    test_case[i, 4] = max(s1, s2)


def generate_rand_case(num_agents, side_length, speed_bnds, radius_bnds, rng=np.random):
    """gen_rand_testcases.generate_rand_case (:144-233): rejection sampling
    with start/goal separation, collision clearance, and the
    no-straight-line-solution filter."""
    test_case = np.zeros((num_agents, 6))
    for i in range(num_agents):
        _sample_radius_speed(test_case, i, speed_bnds, radius_bnds, rng)
        while True:
            side_length *= 1.01
            start = side_length * 2 * rng.rand(2) - side_length
            end = side_length * 2 * rng.rand(2) - side_length

            if_collide = False
            for j in range(i):
                r = test_case[j, 5] + test_case[i, 5] + GETTING_CLOSE_RANGE
                if np.linalg.norm(start - test_case[j, 0:2]) < r:
                    if_collide = True
                    break
                if np.linalg.norm(end - test_case[j, 2:4]) < r:
                    if_collide = True
                    break
            if if_collide:
                continue

            if i >= 1:
                all_straight = True
                for j in range(i):
                    r = test_case[j, 5] + test_case[i, 5] + GETTING_CLOSE_RANGE
                    if not _if_permit_straight_line(
                        test_case[j, 0:2], test_case[j, 2:4], test_case[j, 4],
                        start, end, test_case[i, 4], r,
                    ):
                        all_straight = False
                        break
                if all_straight:
                    continue

            if np.linalg.norm(start - end) > side_length * 0.5:
                break

        test_case[i, 0:2] = start
        test_case[i, 2:4] = end
    return test_case


def _rejection_ring(test_case, i, r, offset, rng):
    """Shared swap/circle ring sampling with collision rejection
    (gen_rand_testcases.py:347-373, 394-420)."""
    counter = 0
    while True:
        if counter > 10:
            r *= 1.01
            counter = 0
        start_angle = rng.rand() * 2 * np.pi - np.pi
        end_angle = np.pi + start_angle
        start = np.array([r * np.cos(start_angle), r * np.sin(start_angle)]) + offset
        end = np.array([r * np.cos(end_angle), r * np.sin(end_angle)]) + offset
        if_collide = False
        for j in range(i):
            rad = test_case[j, 5] + test_case[i, 5] + GETTING_CLOSE_RANGE
            if np.linalg.norm(start - test_case[j, 0:2]) < rad:
                if_collide = True
                break
            if np.linalg.norm(end - test_case[j, 2:4]) < rad:
                if_collide = True
                break
        if if_collide:
            counter += 1
            continue
        return start, end, r


def generate_swap_case(num_agents, side_length, speed_bnds, radius_bnds, rng=np.random):
    """Two agents swap head-on; the rest cross on a ring
    (gen_rand_testcases.py:322-377)."""
    r_min = num_agents / 2.0
    r = rng.rand() * 2.0 + r_min
    test_case = np.zeros((num_agents, 6))
    r_swap = 1.5 + rng.rand() * 2.0
    offset = np.array([0, 1.0 + r_min + rng.rand() * 2.0])
    if rng.rand() > 0.5:
        offset = -offset
    for i in range(num_agents):
        _sample_radius_speed(test_case, i, speed_bnds, radius_bnds, rng)
        if i == 0:
            start, end = np.array([-r_swap, 0.0]), np.array([r_swap, 0.0])
        elif i == 1:
            start, end = np.array([r_swap, 0.0]), np.array([-r_swap, 0.0])
        else:
            start, end, r = _rejection_ring(test_case, i, r, offset, rng)
        test_case[i, 0:2] = start
        test_case[i, 2:4] = end
    return test_case


def generate_circle_case(num_agents, side_length, speed_bnds, radius_bnds, rng=np.random):
    """All agents on a ring with antipodal goals (gen_rand_testcases.py:379-423)."""
    r_min = num_agents / 2.0
    r = rng.rand() * 2.0 + r_min
    test_case = np.zeros((num_agents, 6))
    zero_offset = np.zeros(2)
    for i in range(num_agents):
        _sample_radius_speed(test_case, i, speed_bnds, radius_bnds, rng)
        start, end, r = _rejection_ring(test_case, i, r, zero_offset, rng)
        test_case[i, 0:2] = start
        test_case[i, 2:4] = end
    return test_case


def generate_rand_test_case_multi(num_agents, side_length, speed_bnds, radius_bnds,
                                  rng=np.random):
    """15% swap / 15% circle / 70% random
    (gen_rand_testcases.py:111-142)."""
    random_case = rng.rand()
    if random_case < 0.15:
        return generate_swap_case(num_agents, side_length, speed_bnds, radius_bnds, rng)
    elif 0.15 < random_case < 0.3:
        return generate_circle_case(num_agents, side_length, speed_bnds, radius_bnds, rng)
    else:
        return generate_rand_case(num_agents, side_length, speed_bnds, radius_bnds, rng)


def random_scenario(
    num_agents: Optional[int] = None,
    side_length=4,
    speed_bnds=(0.5, 2.0),
    radius_bnds=(0.2, 0.8),
    policies_arg="noncoop",
    policy_distr=None,
    policy_to_ensure: Optional[str] = None,
    agents_dynamics: str = "unicycle",
    max_num_agents: int = 4,
    evaluate_mode: bool = True,
    rng=np.random,
) -> Scenario:
    """``get_testcase_random`` + ``cadrl_test_case_to_agents``
    (envs/test_cases.py:212-253, 495-590) as one host-side sampler."""
    if num_agents is None:
        num_agents = rng.randint(2, max_num_agents + 1)

    if isinstance(side_length, (list, tuple)):
        for comp in side_length:
            if comp["num_agents"][0] <= num_agents < comp["num_agents"][1]:
                side_length = rng.uniform(comp["side_length"][0], comp["side_length"][1])
        assert isinstance(side_length, float)

    case = generate_rand_test_case_multi(
        num_agents, side_length, list(speed_bnds), list(radius_bnds), rng
    )

    # policy assignment (envs/test_cases.py:509-535)
    if isinstance(policies_arg, str):
        policy_list = [policies_arg] * num_agents
    else:
        if policy_distr is None:
            policy_list = list(policies_arg)
        else:
            policy_list = list(rng.choice(policies_arg, num_agents, p=policy_distr))
            if policy_to_ensure is not None and policy_to_ensure not in policy_list:
                policy_list[rng.randint(len(policy_list))] = policy_to_ensure

    # heading: toward goal in eval mode, random in train mode (:556-562)
    if evaluate_mode:
        heading = None
    else:
        heading = rng.uniform(-np.pi, np.pi, num_agents)

    return Scenario(
        pos=case[:, 0:2],
        goal=case[:, 2:4],
        pref_speed=case[:, 4],
        radius=case[:, 5],
        heading=heading,
        policy_id=np.array([policies.POLICY_NAMES[p] for p in policy_list], np.int32),
        dynamics_id=np.full(num_agents, dyn.DYNAMICS_NAMES[agents_dynamics], np.int32),
    )


def scenario_pool(n_cases: int, num_agents: int, seed: int = 0, **kwargs) -> np.ndarray:
    """Pre-generate a [n_cases, num_agents, 6] pool for in-graph auto-reset
    (scenario generation is data-dependent rejection sampling, so pools are
    built host-side and indexed on device)."""
    rng = np.random.RandomState(seed)
    return np.stack(
        [
            generate_rand_test_case_multi(
                num_agents, kwargs.get("side_length", 4.0),
                list(kwargs.get("speed_bnds", (0.5, 2.0))),
                list(kwargs.get("radius_bnds", (0.2, 0.8))), rng,
            )
            for _ in range(n_cases)
        ]
    )


def scenario_pool_mixed(
    n_cases: int, agent_counts, seed: int = 0, **kwargs
) -> np.ndarray:
    """Pre-generate a [n_cases, max(agent_counts), 7] mixed-density pool.

    Cases cycle round-robin through ``agent_counts``; smaller cases are
    padded to the max count with INVALID parked agents (column 6 is the
    valid flag — ``autoreset.state_from_case`` maps it to
    ``init_state(valid=...)``, whose ``is_done=~valid`` makes padding
    agents inert to sensing, collision, and the PPO alive mask).  This is
    the multi-density training regime of the GA3C-CADRL papers (stages
    mixing 2-4 agents) expressed as one static-shape pool: XLA compiles a
    single step for the max count and the mask does the rest, where the
    reference re-instantiates its env per agent count.
    """
    counts = [int(a) for a in agent_counts]
    a_max = max(counts)
    rng = np.random.RandomState(seed)
    far = 1e4  # same parking convention as Scenario.pad_to (presets.py:69)
    pool = np.zeros((n_cases, a_max, 7))
    for i in range(n_cases):
        a = counts[i % len(counts)]
        case = generate_rand_test_case_multi(
            a, kwargs.get("side_length", 4.0),
            list(kwargs.get("speed_bnds", (0.5, 2.0))),
            list(kwargs.get("radius_bnds", (0.2, 0.8))), rng,
        )
        pool[i, :a, :6] = case
        pool[i, :a, 6] = 1.0
        for k in range(a, a_max):
            # Parked: pos far out (spaced so they never overlap each
            # other), goal distinct so dist-to-goal stays finite.
            pool[i, k] = (far + 4.0 * k, far, far + 4.0 * k + 1.0, far + 1.0,
                          1.0, 0.1, 0.0)
    return pool
