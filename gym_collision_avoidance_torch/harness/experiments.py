"""Evaluation campaigns (port of
:mod:`gym_collision_avoidance_tpu.harness.experiments`).

The reference loops Python episodes one at a time
(``experiments/src/run_full_test_suite.py:54-130``,
``env_utils.run_episode:45-91``).  Here all test cases of a
(policy, agent-count) cell run as one batch on the device: cases are stacked
on the env axis and stepped in lockstep, in chunks of ``chunk_steps`` steps
with no host read inside a chunk, and the loop ends between chunks once every
episode is over.  As in the JAX package's ``lax.scan`` chunks, finished envs
keep stepping inside a chunk; a done agent's action is zero and its clock,
flags and position freeze, so the stats, read from the final state, do not
depend on the chunk size or on which cases share the batch.

The final state, the done flags, step counts and rewards reach the host in
one copy, and the per-episode stats (the reference's schema,
env_utils.py:52-88) are built from numpy.  :func:`summarize_stats` is the
pandas-free summary of a cell; :func:`run_full_test_suite` and
:func:`summarize_suite` keep the JAX signatures and return pandas DataFrames
(pandas is imported only inside the functions that build DataFrames).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core import dynamics as dyn
from gym_collision_avoidance_torch.core.device import params_to_device, resolve_device
from gym_collision_avoidance_torch.core.state import EnvState, init_state
from gym_collision_avoidance_torch.env.step import env_step
from gym_collision_avoidance_torch.harness import registry as hreg
from gym_collision_avoidance_torch.harness import stats as hstats
from gym_collision_avoidance_torch.policies import registry as policies
from gym_collision_avoidance_torch.scenarios import presets, suites


def stack_scenarios(scenarios: Sequence[presets.Scenario], cfg: EnvConfig,
                    device=None) -> EnvState:
    """One ``[E, A]`` state holding each scenario's ``to_state`` as an env,
    built in one :func:`init_state` call (missing headings point at the goal,
    missing ids take ``init_state``'s defaults, as one scenario's would)."""
    A = scenarios[0].num_agents
    if any(sc.num_agents != A for sc in scenarios):
        raise ValueError("all scenarios must have the same agent count "
                         "(pad with Scenario.pad_to)")

    def stacked(field, fill, dtype):
        return np.stack([np.full(A, fill, dtype) if getattr(sc, field) is None
                         else np.asarray(getattr(sc, field), dtype) for sc in scenarios])

    return init_state(
        cfg,
        pos=np.stack([np.asarray(sc.pos) for sc in scenarios]),
        goal=np.stack([np.asarray(sc.goal) for sc in scenarios]),
        radius=np.stack([np.asarray(sc.radius) for sc in scenarios]),
        pref_speed=np.stack([np.asarray(sc.pref_speed) for sc in scenarios]),
        heading=stacked("heading", np.nan, np.float64),
        policy_id=stacked("policy_id", policies.NONCOOP, np.int32),
        dynamics_id=stacked("dynamics_id", dyn.UNICYCLE, np.int32),
        valid=stacked("valid", True, bool),
        device=device,
    )


@dataclasses.dataclass
class EpisodeBatch:
    """What :func:`run_episode_batch` ran: per-episode ``stats`` in the
    reference's schema (env_utils.py:52-88), the ``lockstep_steps`` every env
    of the batch was stepped (whole chunks), and the ``[T, E, A, 2]``
    ``positions`` of every step (numpy) if trajectories were collected."""

    stats: List[dict]
    lockstep_steps: int
    positions: Optional[np.ndarray] = None


def run_episode_batch(
    scenarios: Sequence[presets.Scenario],
    cfg: EnvConfig,
    params=None,
    chunk_steps: int = 128,
    max_steps: Optional[int] = None,
    collect_trajectories: bool = False,
    device=None,
) -> EpisodeBatch:
    """Run one episode per scenario, all in lockstep on ``device`` (``None``
    means CUDA).

    All scenarios must share the agent count (pad with
    ``Scenario.pad_to`` otherwise).  ``params`` is copied to the device.
    """
    device = resolve_device(device)
    active = tuple(sorted(set(p for sc in scenarios for p in sc.active_policies)))
    state = stack_scenarios(scenarios, cfg, device)
    params = params_to_device(params, device)
    E, A = state.pos.shape[:2]

    straight_line_time = np.stack([
        (np.linalg.norm(sc.goal - sc.pos, axis=1) - cfg.near_goal_threshold) / sc.pref_speed
        for sc in scenarios
    ])
    if max_steps is None:
        max_steps = int(np.ceil(float(state.time_remaining.max()) / cfg.dt)) + 2

    done = torch.zeros(E, dtype=torch.bool, device=device)
    steps = torch.zeros(E, dtype=torch.int32, device=device)
    total_reward = torch.zeros((E, A), dtype=state.pos.dtype, device=device)
    traj = []
    lockstep_steps = 0
    n_chunks = (max_steps + chunk_steps - 1) // chunk_steps
    for _ in range(n_chunks):
        for _ in range(chunk_steps):
            state, _obs, rew, game_over, _info = env_step(state, None, cfg, params, active)
            alive = ~done
            total_reward = total_reward + rew * alive[:, None]
            steps = steps + alive.to(torch.int32)
            done = done | game_over
            if collect_trajectories:
                traj.append(state.pos)
        lockstep_steps += chunk_steps
        if bool(done.all()):
            break

    collision, all_at_goal, any_stuck = hstats.outcome_flags(
        state.in_collision, state.is_at_goal, state.valid)
    host = {k: v.cpu().numpy() for k, v in (
        ("valid", state.valid), ("t", state.t), ("steps", steps),
        ("total_reward", total_reward), ("collision", collision),
        ("all_at_goal", all_at_goal), ("any_stuck", any_stuck))}

    stats = []
    for e in range(E):
        valid = host["valid"][e]
        t = host["t"][e][valid]
        collision_e, all_at_goal_e = bool(host["collision"][e]), bool(host["all_at_goal"][e])
        stats.append({
            "total_reward": host["total_reward"][e][valid],
            "steps": int(host["steps"][e]),
            "num_agents": int(valid.sum()),
            "time_to_goal": t,
            "total_time_to_goal": float(np.sum(t)),
            "extra_time_to_goal": t - straight_line_time[e][valid],
            "collision": collision_e,
            "all_at_goal": all_at_goal_e,
            "any_stuck": bool(host["any_stuck"][e]),
            "outcome": hstats.outcome_str(collision_e, all_at_goal_e),
        })
    positions = torch.stack(traj).cpu().numpy() if collect_trajectories else None
    return EpisodeBatch(stats, lockstep_steps, positions)


def run_batched_episodes(
    scenarios: Sequence[presets.Scenario],
    cfg: EnvConfig,
    params=None,
    chunk_steps: int = 128,
    max_steps: Optional[int] = None,
    collect_trajectories: bool = False,
    device=None,
):
    """:func:`run_episode_batch` with the JAX package's signature and returns.

    Returns:
        list of per-episode stats dicts in the reference's schema
        (env_utils.py:52-88), plus ``[T, E, A, 2]`` positions (numpy, every
        step of every chunk run) if ``collect_trajectories``.
    """
    run = run_episode_batch(scenarios, cfg, params, chunk_steps, max_steps,
                            collect_trajectories, device)
    return (run.stats, run.positions) if collect_trajectories else run.stats


def suite_scenarios(num_agents: int, policy: str,
                    num_test_cases: int = 500) -> List[presets.Scenario]:
    """The first ``num_test_cases`` frozen cases of the ``num_agents`` suite,
    every agent on the named policy (``run_full_test_suite``'s cell)."""
    spec = hreg.POLICY_SPECS[policy]
    cases = suites.preset_test_cases(num_agents, full_test_suite=True)[:num_test_cases]
    return [
        presets.Scenario(
            pos=c[:, 0:2], goal=c[:, 2:4], pref_speed=c[:, 4], radius=c[:, 5],
            policy_id=np.full(num_agents, spec.policy_id, np.int32),
        )
        for c in cases
    ]


def policy_setup(policy: str, cfg: EnvConfig, device=None):
    """``(cfg, params)`` of a named policy: the registry's sensor settings
    applied to ``cfg`` and its checkpoints on ``device`` (None if it needs
    none)."""
    spec = hreg.POLICY_SPECS[policy]
    pcfg = hreg.cfg_for_policy(policy, cfg)
    params = (hreg.load_params(*spec.needs_params, device=device, dtype=pcfg.dtype)
              if spec.needs_params else None)
    return pcfg, params


def suite_cell(num_agents: int, policy: str, num_test_cases: int = 500,
               cfg: Optional[EnvConfig] = None, device=None):
    """``(scenarios, cfg, params)`` of one cell of the campaign: the frozen
    cases, the registry's config (from ``cfg``, default float32
    ``EnvConfig.evaluate``) and params for ``policy``."""
    pcfg, params = policy_setup(policy, cfg or EnvConfig.evaluate(dtype="float32"), device)
    return suite_scenarios(num_agents, policy, num_test_cases), pcfg, params


def run_suite_cell(num_agents: int, policy: str, num_test_cases: int = 500,
                   cfg: Optional[EnvConfig] = None, device=None) -> EpisodeBatch:
    """:func:`run_episode_batch` over :func:`suite_cell`."""
    scenarios, pcfg, params = suite_cell(num_agents, policy, num_test_cases, cfg, device)
    return run_episode_batch(scenarios, pcfg, params, device=device)


def stats_frame(stats: Sequence[dict], policy: str) -> "pandas.DataFrame":
    """One cell's stats as the reference's per-episode DataFrame (a
    ``test_case`` and ``policy_id`` column before the stats)."""
    import pandas as pd

    return pd.DataFrame([{"test_case": i, "policy_id": policy, **s}
                         for i, s in enumerate(stats)])


def write_stats_pickle(df: "pandas.DataFrame", out_dir: str, num_agents: int,
                       policy: str) -> str:
    """Write a :func:`stats_frame` where the reference records it,
    ``<out_dir>/<N>_agents/stats/stats_<policy>.p``; returns the path."""
    d = os.path.join(out_dir, f"{num_agents}_agents", "stats")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"stats_{policy}.p")
    df.to_pickle(path)
    return path


def run_full_test_suite(
    policies_to_test: Sequence[str] = ("CADRL", "RVO", "GA3C-CADRL-10"),
    num_agents_to_test: Sequence[int] = (2, 3, 4),
    num_test_cases: int = 500,
    cfg: Optional[EnvConfig] = None,
    out_dir: Optional[str] = None,
    record_pickle_files: bool = False,
    device=None,
):
    """The reference's evaluation campaign (``FullTestSuite`` config +
    run_full_test_suite.py), batched per cell.

    Returns:
        {(num_agents, policy): pandas.DataFrame} with one row per episode.
    """
    results = {}
    for num_agents in num_agents_to_test:
        for policy in policies_to_test:
            run = run_suite_cell(num_agents, policy, num_test_cases, cfg, device)
            df = results[(num_agents, policy)] = stats_frame(run.stats, policy)
            if record_pickle_files and out_dir is not None:
                write_stats_pickle(df, out_dir, num_agents, policy)
    return results


def summarize_stats(stats: Sequence[dict]) -> Dict[str, float]:
    """One cell's success rates and extra time-to-goal, from
    :func:`run_batched_episodes`' stats list: the columns of
    :func:`summarize_suite` but ``num_agents`` and ``policy``
    (``process_full_test_suite_pickles.py:20-34``)."""
    collision = np.array([s["collision"] for s in stats], bool)
    stuck = np.array([s["any_stuck"] for s in stats], bool) & ~collision
    pct_collision = 100.0 * collision.mean()
    pct_stuck = 100.0 * stuck.mean()
    extra = [s["extra_time_to_goal"] for s, c in zip(stats, collision) if not c]
    extra = np.concatenate(extra) if extra else np.array([np.nan])
    return {
        "pct_collision": float(pct_collision),
        "pct_stuck": float(pct_stuck),
        "pct_success": float(100.0 - pct_collision - pct_stuck),
        "mean_extra_time_to_goal": float(np.mean(extra)),
        "p90_extra_time_to_goal": float(np.percentile(extra, 90)),
    }


SUMMARY_COLUMNS = ("num_agents", "policy", "pct_collision", "pct_stuck", "pct_success",
                   "mean_extra_time_to_goal", "p90_extra_time_to_goal")


def summary_table(rows: Sequence[dict]) -> List[str]:
    """Lines of a fixed-width table of :data:`SUMMARY_COLUMNS` rows (the
    CLIs' printout of :func:`summarize_suite`)."""
    lines = [" ".join(f"{c:>24}" for c in SUMMARY_COLUMNS)]
    for row in rows:
        lines.append(" ".join(f"{row[c]:>24.6g}" if isinstance(row[c], float)
                              else f"{row[c]:>24}" for c in SUMMARY_COLUMNS))
    return lines


def write_summary_csv(path: str, rows: Sequence[dict]) -> str:
    """Write :data:`SUMMARY_COLUMNS` rows as a CSV file (the columns of
    :func:`summarize_suite`'s DataFrame, without pandas); returns the path."""
    import csv

    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=SUMMARY_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    return path


def summarize_suite(results: Dict) -> "pandas.DataFrame":
    """Aggregate per-cell success rates / mean extra time-to-goal of
    :func:`run_full_test_suite`'s results, like
    ``process_full_test_suite_pickles.py:20-34``."""
    import pandas as pd

    rows = []
    for (num_agents, policy), df in results.items():
        rows.append({"num_agents": num_agents, "policy": policy,
                     **summarize_stats(df.to_dict("records"))})
    return pd.DataFrame(rows)


def run_formations_campaign(
    policy: str = "GA3C-CADRL-10",
    letters: Sequence[str] = ("C", "A", "D", "R", "L"),
    num_episodes: int = 5,
    num_agents: int = 6,
    cfg: Optional[EnvConfig] = None,
    out_dir: Optional[str] = None,
    animate: bool = False,
    seed: int = 0,
    device=None,
):
    """Letter-formation demo (``experiments/src/run_cadrl_formations.py``):
    agents persist across episodes -- each episode they navigate from
    wherever they are to the next letter's (shuffled) slots.

    Returns list of (letter, stats, [T, A, 2] trajectory).
    """
    from gym_collision_avoidance_torch.harness import visualize

    if cfg is None:
        cfg = EnvConfig.evaluate(
            dtype="float32", near_goal_threshold=0.2,
            max_num_other_agents_observed=19,
            agent_sorting_method="closest_last",
        )
    spec = hreg.POLICY_SPECS[policy]
    pcfg, params = policy_setup(policy, cfg, device)
    rng = np.random.RandomState(seed)

    # initial configuration: the 6-agent small-suite circle
    current_pos = suites.preset_test_cases(num_agents)[0][:, 0:2]
    out = []
    for ep in range(num_episodes):
        letter = letters[ep % len(letters)]
        goals = suites.formation_goals(letter, num_agents, rng)
        sc = presets.Scenario(
            pos=current_pos.copy(), goal=goals,
            pref_speed=np.ones(num_agents), radius=np.full(num_agents, 0.5),
            policy_id=np.full(num_agents, spec.policy_id, np.int32),
        )
        stats, traj = run_batched_episodes([sc], pcfg, params, collect_trajectories=True,
                                           device=device)
        T = stats[0]["steps"]
        positions = traj[:T, 0]
        current_pos = positions[-1]
        if out_dir is not None:
            png = os.path.join(out_dir, f"{ep:03d}_{letter}_{num_agents}agents.png")
            visualize.plot_episode(
                positions, np.asarray(sc.radius), goals=goals, dt=pcfg.dt,
                circles_along_traj=False, limits=[[-5, 6], [-2, 7]],
                save_path=png,
            )
            if animate:
                visualize.animate_episode(
                    positions, np.asarray(sc.radius), goals=goals, dt=pcfg.dt,
                    circles_along_traj=False, limits=[[-5, 6], [-2, 7]],
                    save_path=png.replace(".png", ".gif"),
                )
        out.append((letter, stats[0], positions))
    return out


# -- per-episode outcome records (tests/data/torch_suite_jax_outcomes.json) --

# A cell agrees with a reference when no more than MAX_OUTCOMES_APART of its
# episodes have another outcome and no more than MAX_STEPS_APART_SHARE of
# them another step count.  Set from the readings on the frozen suites
# against JAX on the CPU (float32): the port on an H100 and on the CPU gave
# JAX's outcome on all 4500 episodes of the nine cells and its step count on
# all but 0-4 of a cell's 500 (RVO's deadlocks and CADRL's knife edges).
# GA3C-CADRL-10 with bf16 weights, or with TF32 products, moves far more.
MAX_OUTCOMES_APART = 0
MAX_STEPS_APART_SHARE = 0.02


def cell_record(num_agents: int, policy: str, stats: Sequence[dict]) -> dict:
    """One cell in the outcome-record schema: per-episode ``outcome`` and
    ``steps`` and the :func:`summarize_stats` summary."""
    return {"num_agents": num_agents, "policy": policy, "cases": len(stats),
            "outcome": [s["outcome"] for s in stats],
            "steps": [int(s["steps"]) for s in stats],
            "summary": summarize_stats(stats)}


def load_outcome_records(path: str) -> Dict[tuple, dict]:
    """``{(num_agents, policy): cell}`` of an outcome-record JSON file."""
    import json

    with open(path) as f:
        doc = json.load(f)
    return {(c["num_agents"], c["policy"]): c for c in doc["cells"]}


def compare_outcomes(ref: dict, got: dict) -> dict:
    """A cell record against a reference cell whose first cases are the
    record's: the share of episodes with the reference's outcome, the
    differing cases, the episodes whose step counts differ, and how far
    apart the two put each summary percentage over those cases; ``ok`` if
    at most :data:`MAX_OUTCOMES_APART` outcomes and
    :data:`MAX_STEPS_APART_SHARE` of the step counts differ."""
    n = len(got["outcome"])
    if len(ref["outcome"]) < n:
        raise ValueError(f"{n} episodes against a reference of {len(ref['outcome'])}")
    differ = [i for i in range(n) if ref["outcome"][i] != got["outcome"][i]]
    steps_apart = [i for i in range(n) if ref["steps"][i] != got["steps"][i]]

    def pct(record, outcome):
        return 100.0 * sum(o == outcome for o in record["outcome"][:n]) / n

    points = {k: abs(pct(got, o) - pct(ref, o)) for k, o in (
        ("pct_success", "all_at_goal"), ("pct_collision", "collision"), ("pct_stuck", "stuck"))}
    return {"cases": n, "outcome_agreement": 1.0 - len(differ) / n,
            "differing_cases": differ, "steps_apart_cases": steps_apart,
            "pct_points_apart": points,
            "ok": (len(differ) <= MAX_OUTCOMES_APART
                   and len(steps_apart) <= MAX_STEPS_APART_SHARE * n)}
