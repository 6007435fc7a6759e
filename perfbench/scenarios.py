"""The benchmark's scenario generator: a frozen copy, in plain NumPy, of the
upstream random test-case generator as the port carries it
(``scenarios/random_cases.py:generate_rand_test_case_multi`` and
``scenario_pool``; upstream ``envs/policies/CADRL/scripts/multi/
gen_rand_testcases.py`` and ``envs/test_cases.py:212-253``).

The copy lives here so that the yardstick does not move when the program's
generator does: every run draws its pool from ``--seed`` with this code.
``perfbench/tests/test_perfbench_cpu.py`` holds it equal to the program's
``scenario_pool`` on three seeds.
"""

from __future__ import annotations

import numpy as np

GETTING_CLOSE_RANGE = 0.2  # CADRL global_var.py:8


def _dist_point_to_segment(p1, p2, p3):
    d = p2 - p1
    if np.linalg.norm(d) < 1e-5:
        u = 0.0
    else:
        u = np.dot(d, (p3 - p1)) / (np.linalg.norm(d) ** 2.0)
    u = max(0.0, min(u, 1.0))
    inter = p1 + u * d
    return np.linalg.norm(p3 - inter)


def _dist_between_segs(x1, x2, y1, y2):
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


def _rand_case(num_agents, side_length, speed_bnds, radius_bnds, rng):
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


def _swap_case(num_agents, side_length, speed_bnds, radius_bnds, rng):
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


def _circle_case(num_agents, side_length, speed_bnds, radius_bnds, rng):
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


def generate_rand_test_case_multi(num_agents, side_length, speed_bnds, radius_bnds, rng):
    """15% swap / 15% circle / 70% random (gen_rand_testcases.py:111-142)."""
    random_case = rng.rand()
    if random_case < 0.15:
        return _swap_case(num_agents, side_length, speed_bnds, radius_bnds, rng)
    elif 0.15 < random_case < 0.3:
        return _circle_case(num_agents, side_length, speed_bnds, radius_bnds, rng)
    return _rand_case(num_agents, side_length, speed_bnds, radius_bnds, rng)


def scenario_pool(n_cases, num_agents, seed, side_length=4.0, speed_bnds=(0.5, 2.0),
                  radius_bnds=(0.2, 0.8)) -> np.ndarray:
    """``[n_cases, num_agents, 6]`` rows ``[px, py, gx, gy, pref_speed,
    radius]`` from ``np.random.RandomState(seed)`` (a seed below 2**32)."""
    rng = np.random.RandomState(seed)
    return np.stack([generate_rand_test_case_multi(num_agents, side_length, list(speed_bnds),
                                                   list(radius_bnds), rng)
                     for _ in range(n_cases)])
