"""Dataset-collection campaigns (port of
:mod:`gym_collision_avoidance_tpu.harness.datasets`).

* :func:`collect_regression_dataset` -- (state, CADRL action, CADRL value)
  triples, the golden regression probes of
  ``experiments/src/collect_regression_dataset.py:13-61``.
* :func:`collect_trajectory_dataset` -- per-step robot/pedestrian dicts from
  RVO episodes, the prediction-research format of
  ``experiments/src/run_trajectory_dataset_creator.py:43-156``.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core.device import resolve_device
from gym_collision_avoidance_torch.env.step import env_reset, env_step
from gym_collision_avoidance_torch.models import cadrl as cadrl_net
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.policies import cadrl as cadrl_policy
from gym_collision_avoidance_torch.policies import registry as P
from gym_collision_avoidance_torch.scenarios import random_cases


def _dump(obj, out_path: str):
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(obj, f)


def collect_regression_dataset(
    num_datapts: int,
    num_agents: int = 4,
    cfg: Optional[EnvConfig] = None,
    seed: int = 0,
    out_path: Optional[str] = None,
    device=None,
):
    """Roll CADRL episodes on random scenarios (one env at a time on
    ``device``, ``None`` meaning CUDA), recording per agent-step the
    flattened obs (minus ``is_learning``), the CADRL action, and the CADRL
    state value.

    Returns:
        (STATES [N, obs_len], ACTIONS [N, 2], VALUES [N, 1]) numpy arrays
    """
    if cfg is None:
        cfg = EnvConfig.evaluate(dtype="float64")
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    params = {"cadrl": cadrl_net.load_params(dtype=cfg.dtype, device=device)}
    active = (P.CADRL,)

    states_buf, actions_buf, values_buf = [], [], []
    n = 0
    while n < num_datapts:
        sc = random_cases.random_scenario(num_agents=num_agents, policies_arg="CADRL", rng=rng)
        state, obs = env_reset(sc.to_state(cfg, device=device), cfg)
        game_over = False
        while not game_over and n < num_datapts:
            vec = obs_spec.flatten_policy_obs(obs)[0].cpu().numpy()  # drops is_learning
            actions = cadrl_policy.cadrl_kernel(state, cfg, params)[0]
            values = cadrl_policy.cadrl_state_values(state, cfg, params)[0]
            states_buf.append(vec)
            actions_buf.append(actions.cpu().numpy())
            values_buf.append(values.cpu().numpy())
            n += vec.shape[0]
            state, obs, _rew, game_over_arr, _info = env_step(state, None, cfg, params, active)
            game_over = bool(game_over_arr[0])

    STATES = np.concatenate(states_buf)[:num_datapts]
    ACTIONS = np.concatenate(actions_buf)[:num_datapts]
    VALUES = np.concatenate(values_buf)[:num_datapts].reshape(-1, 1)
    if out_path is not None:
        _dump([STATES, ACTIONS, VALUES], out_path)
    return STATES, ACTIONS, VALUES


def collect_trajectory_dataset(
    num_trajs: int = 8,
    cfg: Optional[EnvConfig] = None,
    seed: int = 0,
    future_plan_horizon_secs: float = 3.0,
    out_path: Optional[str] = None,
    device=None,
) -> List[List[dict]]:
    """2-agent RVO episodes -> per-step dicts (control command, predicted
    future commands/positions, pedestrian state, robot state, goal),
    mirroring ``add_traj`` (run_trajectory_dataset_creator.py:43-100).
    Each episode runs through :func:`harness.experiments.run_batched_episodes`
    on ``device`` (``None`` means CUDA)."""
    from gym_collision_avoidance_torch.harness import experiments

    if cfg is None:
        cfg = EnvConfig.evaluate(dtype="float64")
    rng = np.random.RandomState(seed)
    horizon_steps = int(future_plan_horizon_secs / cfg.dt)

    trajs = []
    for _ in range(num_trajs):
        sc = random_cases.random_scenario(num_agents=2, policies_arg="RVO", rng=rng)
        stats, pos_traj = experiments.run_batched_episodes(
            [sc], cfg, collect_trajectories=True, device=device
        )
        T = stats[0]["steps"]
        pos = pos_traj[:T, 0]                              # [T, A, 2]
        vel = np.diff(pos, axis=0, prepend=pos[:1]) / cfg.dt
        speed = np.linalg.norm(vel, axis=-1)               # [T, A]
        heading = np.arctan2(vel[..., 1], vel[..., 0])
        dheading = np.diff(heading, axis=0, prepend=heading[:1])
        omega = dheading / cfg.dt

        traj = []
        for t in range(T):
            th = min(T, t + horizon_steps)
            traj.append(
                {
                    "control_command": np.array([speed[t, 0], omega[t, 0]]),
                    "predicted_cmd": np.dstack([speed[t:th, 0], omega[t:th, 0]]),
                    "future_positions": pos[t:th, 0],
                    "pedestrian_state": {
                        "position": pos[t, 1],
                        "velocity": vel[t, 1],
                    },
                    "robot_state": np.array([pos[t, 0, 0], pos[t, 0, 1], dheading[t, 0]]),
                    "goal_position": np.asarray(sc.goal[0]),
                }
            )
        trajs.append(traj)

    if out_path is not None:
        _dump(trajs, out_path)
    return trajs
