"""Named-policy registry for experiments (port of
:mod:`gym_collision_avoidance_tpu.harness.registry`).

Shrunk to the checkpoints actually shipped with the reference (the
reference registry, ``experiments/src/env_utils.py:102-492``, also lists
dozens of paper-ablation entries with hard-coded EC2 paths that don't
resolve anywhere -- those are dead and not reproduced).  The fourteen
names, their sensor settings and checkpoints are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.policies import registry as policies


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    policy_id: int
    sensors: Tuple[str, ...] = ("other_agents_states",)
    # sensor args become env-config overrides (the reference passes them to
    # Sensor.set_args per agent; here sensing is env-level config)
    agent_sorting_method: Optional[str] = None
    max_num_other_agents_observed: Optional[int] = None
    needs_params: Tuple[str, ...] = ()
    # additional EnvConfig overrides, as (field, value) pairs (hashable)
    extra_cfg: Tuple[Tuple[str, object], ...] = ()


POLICY_SPECS: Dict[str, PolicySpec] = {
    # env_utils.py:464-473
    "GA3C-CADRL-10": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_last",
        max_num_other_agents_observed=19,
        needs_params=("ga3c_cadrl",),
    ),
    # env_utils.py:475-480 (commented-out reference entry; checkpoint ships)
    "GA3C-CADRL-4-LSTM": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_last",
        max_num_other_agents_observed=19,
        needs_params=("ga3c_cadrl:20190727_015942",),
    ),
    # second shipped 2019 run (checkpoints/run-20190727_192048-qedrf08y);
    # unnamed in the reference registry
    "GA3C-CADRL-10-LSTM-2": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_last",
        max_num_other_agents_observed=19,
        needs_params=("ga3c_cadrl:20190727_192048",),
    ),
    # env_utils.py:481-488
    "CADRL": PolicySpec(policy_id=policies.CADRL, needs_params=("cadrl",)),
    # the commented alternative net at CADRLPolicy.py:22 (mode =
    # 'rotate_constr', passing_side = 'right', iteration = 1300): activates
    # the passing-side social-norm cost in the lookahead
    "CADRL-rotate-right": PolicySpec(
        policy_id=policies.CADRL,
        needs_params=("cadrl:rotate_constr_right",),
        extra_cfg=(
            ("cadrl_passing_side", "right"),
            ("cadrl_mode", "rotate_constr"),
        ),
    ),
    # not a reference checkpoint: trained from scratch by this repo's
    # on-device PPO trainer (RESULTS.md "On-device-trained policies"),
    # shipped as the reproducibility artifact for that table's run C.
    # K=3 other-agent slots and closest_first sorting, matching its
    # training env (at 2 agents there is one visible other, so the order
    # convention cannot matter there — but keep it consistent).
    "PPO-selfplay-2agent": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_first",
        max_num_other_agents_observed=3,
        needs_params=("ga3c_cadrl:ppo_selfplay_2agent",),
    ),
    # curriculum continuation of the net above (2-agent -> two 4-agent
    # self-play stages): 99.0/96.0/95.8% success at 2/3/4 agents on the
    # frozen suites — above RVO on every tier (RESULTS.md run F)
    "PPO-selfplay-4agent": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_first",
        max_num_other_agents_observed=3,
        needs_params=("ga3c_cadrl:ppo_selfplay_4agent_curr",),
    ),
    # final curriculum stage (RESULTS.md run G): above RVO at every
    # suite density (2-10 agents), ~matches the frozen nets at 2-5
    "PPO-selfplay-6agent": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_first",
        max_num_other_agents_observed=3,
        needs_params=("ga3c_cadrl:ppo_selfplay_6agent_curr",),
    ),
    # flagship 5-stage curriculum net (RESULTS.md run H): above RVO at
    # every suite density, above the IROS18 checkpoint at 4 agents, and
    # within ~1 point of it everywhere else
    "PPO-selfplay-10agent": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_first",
        max_num_other_agents_observed=3,
        needs_params=("ga3c_cadrl:ppo_selfplay_10agent_curr",),
    ),
    # the 6-stage curriculum trained end-to-end ON THE TPU CHIP in ~10
    # min (scripts/train_curriculum.sh, seed 1; RESULTS.md "TPU-trained
    # curriculum"): above the CPU flagship at 2/5/6/8/10 agents and
    # above the reference's IROS18 checkpoint at 4/6/8/10 (98.0/96.6%
    # success at 8/10 vs the paper net's 97.2/96.0)
    "PPO-selfplay-10agent-TPU": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_first",
        max_num_other_agents_observed=3,
        needs_params=("ga3c_cadrl:ppo_selfplay_10agent_tpu",),
    ),
    # bf16-weights serving variant of GA3C-CADRL-10 (matmul weights in
    # bfloat16, norm constants f32; models/ga3c_cadrl.load_params).  NOT
    # bit-identical to f32 — registered so the 500-case suites can
    # quality-gate the +13% serving throughput end-to-end (RESULTS.md
    # "bf16 serving quality gate").
    "GA3C-CADRL-10-bf16": PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method="closest_last",
        max_num_other_agents_observed=19,
        needs_params=("ga3c_cadrl:iros18:bf16",),
    ),
    "RVO": PolicySpec(policy_id=policies.RVO),
    "noncoop": PolicySpec(policy_id=policies.NONCOOP),
    "static": PolicySpec(policy_id=policies.STATIC),
}


def load_params(*param_keys: str, device=None, dtype="float32") -> dict:
    """Load the checkpoints named in ``needs_params`` on ``device`` (``None``
    means CUDA).

    A key ``"ga3c_cadrl:<name>"`` selects a GA3C-CADRL checkpoint (a name of
    ``models.ga3c_cadrl.CHECKPOINTS`` or a path); the weights land under the
    ``"ga3c_cadrl"`` params slot that the policy reads, so one env uses one
    GA3C checkpoint at a time.  They are float32, or bfloat16 with a trailing
    ``":bf16"`` (the normalisation constants stay float32), as in the JAX
    package.  ``"cadrl[:<name>]"`` loads an SA-CADRL value net in ``dtype``,
    the env's float type: the JAX loader gives float64 weights under x64 and
    float32 without it, and the port's value net runs in one dtype.
    """
    from gym_collision_avoidance_torch.models import cadrl, ga3c_cadrl

    params = {}
    for key in set(param_keys):
        if key == "ga3c_cadrl" or key.startswith("ga3c_cadrl:"):
            name = key.split(":", 1)[1] if ":" in key else "iros18"
            weights = torch.float32
            if name.endswith(":bf16"):
                name, weights = name[: -len(":bf16")], torch.bfloat16
            params["ga3c_cadrl"] = ga3c_cadrl.load_params(name, dtype=weights, device=device)
        elif key == "cadrl" or key.startswith("cadrl:"):
            name = key.split(":", 1)[1] if ":" in key else "no_constr"
            params["cadrl"] = cadrl.load_params(cadrl.CHECKPOINTS[name], dtype=dtype,
                                                device=device)
        else:
            raise KeyError(f"unknown param set {key}")
    return params


def register_trained_policy(
    name: str,
    ckpt_path: str,
    agent_sorting_method: str = "closest_first",
    max_num_other_agents_observed: Optional[int] = None,
) -> None:
    """Register an on-device-trained GA3C-architecture checkpoint (from
    ``scripts/train_ppo.py --export-params`` or ``scripts/train_ppo_torch.py``) as a named policy, so it
    plugs into every harness entry point (`run_full_test_suite`,
    visualization, benches) exactly like the shipped frozen checkpoints.

    The sensor slot count defaults to the net's own input width
    (``K = (width - 5) / 7``) so the observation matches what the net
    trained on.  ``agent_sorting_method`` MUST match the training-time
    env config — the default here is the trainer's default
    (closest_first, EnvConfig's default; note the reference's shipped
    GA3C nets use closest_last instead).  This is not a nicety: a
    curriculum-trained 4-agent net measured 4.6% suite success when
    evaluated under the mismatched order and 40.2% under its own
    (RESULTS.md).
    """
    if max_num_other_agents_observed is None:
        import numpy as np

        with np.load(ckpt_path) as z:
            width = int(z["input_avg"].shape[0])
        max_num_other_agents_observed = (width - 5) // 7
    POLICY_SPECS[name] = PolicySpec(
        policy_id=policies.GA3C_CADRL,
        agent_sorting_method=agent_sorting_method,
        max_num_other_agents_observed=max_num_other_agents_observed,
        needs_params=(f"ga3c_cadrl:{ckpt_path}",),
    )


def cfg_for_policy(name: str, base_cfg: EnvConfig) -> EnvConfig:
    """Apply a named policy's sensor args to the env config (the analog of
    ``sensor.set_args(...)`` in ``reset_env``, env_utils registry)."""
    spec = POLICY_SPECS[name]
    overrides = {}
    if spec.agent_sorting_method is not None:
        overrides["agent_sorting_method"] = spec.agent_sorting_method
    if spec.max_num_other_agents_observed is not None:
        overrides["max_num_other_agents_observed"] = spec.max_num_other_agents_observed
    overrides.update(dict(spec.extra_cfg))
    return base_cfg.replace(**overrides) if overrides else base_cfg
