"""Scenario definitions (port of
:mod:`gym_collision_avoidance_tpu.scenarios.presets`).

A Scenario is host-side numpy data: ``[px, py, gx, gy, pref_speed, radius]``
rows plus per-agent policy/dynamics ids and optional headings, the format of
the reference's pickled suites (``envs/test_cases.py:495-590``).
``to_state`` builds a one-env ``[1, A]`` :class:`EnvState`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core import dynamics as dyn
from gym_collision_avoidance_torch.core.state import init_state
from gym_collision_avoidance_torch.policies import registry as policies


@dataclasses.dataclass
class Scenario:
    """Host-side description of one episode's initial conditions."""

    pos: np.ndarray          # [A, 2]
    goal: np.ndarray         # [A, 2]
    pref_speed: np.ndarray   # [A]
    radius: np.ndarray       # [A]
    heading: Optional[np.ndarray] = None  # [A]; NaN entries -> toward goal
    policy_id: Optional[np.ndarray] = None
    dynamics_id: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None

    @property
    def num_agents(self) -> int:
        return self.pos.shape[0]

    @property
    def active_policies(self):
        pid = self.policy_id
        if pid is None:
            return (policies.NONCOOP,)
        return tuple(sorted(set(int(p) for p in np.asarray(pid))))

    def to_state(self, cfg: EnvConfig, rng=None, device=None):
        """A ``[1, A]`` state (``device=None`` means CUDA)."""
        def batch(x):
            return None if x is None else np.asarray(x)[None]

        return init_state(
            cfg,
            pos=batch(self.pos),
            goal=batch(self.goal),
            radius=batch(self.radius),
            pref_speed=batch(self.pref_speed),
            heading=batch(self.heading),
            policy_id=batch(self.policy_id),
            dynamics_id=batch(self.dynamics_id),
            valid=batch(self.valid),
            rng=batch(rng),
            device=device,
        )

    def pad_to(self, max_agents: int) -> "Scenario":
        """Pad with invalid agents parked far away, so scenarios of
        different sizes share one batch."""
        A = self.num_agents
        if A == max_agents:
            return self
        pad = max_agents - A
        far = 1e4  # parked far away so they never interact

        def _pad(arr, fill):
            arr = np.asarray(arr)
            shape = (pad,) + arr.shape[1:]
            return np.concatenate([arr, np.full(shape, fill, arr.dtype)])

        heading = self.heading if self.heading is not None else np.full(A, np.nan)
        policy_id = (
            self.policy_id if self.policy_id is not None
            else np.full(A, policies.NONCOOP, np.int32)
        )
        dynamics_id = (
            self.dynamics_id if self.dynamics_id is not None
            else np.full(A, dyn.UNICYCLE, np.int32)
        )
        valid = self.valid if self.valid is not None else np.ones(A, bool)
        # Parked agents get a distinct far goal so dist-to-goal stays finite.
        goal = np.concatenate([np.asarray(self.goal), np.full((pad, 2), far + 1.0)])
        return Scenario(
            pos=_pad(self.pos, far),
            goal=goal,
            pref_speed=_pad(self.pref_speed, 1.0),
            radius=_pad(self.radius, 0.1),
            heading=_pad(heading, 0.0),
            policy_id=_pad(policy_id, policies.STATIC).astype(np.int32),
            dynamics_id=_pad(dynamics_id, dyn.EXTERNAL).astype(np.int32),
            valid=_pad(valid, False).astype(bool),
        )


def from_cadrl_case(
    case: np.ndarray,
    policy: str | Sequence[str] = "noncoop",
    dynamics: str = "unicycle",
    heading: Optional[np.ndarray] = None,
) -> Scenario:
    """A Scenario from a reference-format ``[A, 6]`` test case
    (envs/test_cases.py:9); heading None points at the goal."""
    case = np.asarray(case, np.float64)
    A = case.shape[0]
    if isinstance(policy, str):
        pids = np.full(A, policies.POLICY_NAMES[policy], np.int32)
    else:
        pids = np.array([policies.POLICY_NAMES[p] for p in policy], np.int32)
    dids = np.full(A, dyn.DYNAMICS_NAMES[dynamics], np.int32)
    return Scenario(
        pos=case[:, 0:2],
        goal=case[:, 2:4],
        pref_speed=case[:, 4],
        radius=case[:, 5],
        heading=heading,
        policy_id=pids,
        dynamics_id=dids,
    )


def two_agents_swap(policy="noncoop") -> Scenario:
    """The `get_testcase_two_agents` geometry (envs/test_cases.py:144-175)."""
    case = np.array(
        [
            [-3.0, -3.0, 3.0, 3.0, 1.0, 0.5],
            [3.0, 3.0, -3.0, -3.0, 1.0, 0.5],
        ]
    )
    sc = from_cadrl_case(case, policy=policy)
    sc.heading = np.array([0.0, np.pi])
    return sc


def circle_scenario(num_agents: int, radius: float = None, agent_radius: float = 0.5,
                    pref_speed: float = 1.0, policy: str = "noncoop") -> Scenario:
    """Antipodal circle config (``gen_circle_test_case``,
    envs/test_cases.py:900-911)."""
    if radius is None:
        radius = max(2.0, num_agents * agent_radius)
    angles = 2 * np.pi * np.arange(num_agents) / num_agents
    pos = radius * np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    case = np.concatenate(
        [
            pos,
            -pos,
            np.full((num_agents, 1), pref_speed),
            np.full((num_agents, 1), agent_radius),
        ],
        axis=-1,
    )
    return from_cadrl_case(case, policy=policy)
