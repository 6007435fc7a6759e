"""Evaluate a DRL-Long-architecture net on the frozen suites with the
PyTorch port (the counterpart of ``scripts/eval_drl_long.py``).

Agent 0 runs the net greedily (its mean action in the LearningPolicy's
[0, 1]^2 box, the training-time action semantics), the other agent(s) run
RVO, on the first ``--cases`` frozen cases of the ``--agents`` suite, one env
a case, for ``--steps`` lockstep steps on the card (``--device cpu`` for the
CPU).  The learner observes the 3-deep laserscan stack and the polar goal
and kinematic scalars, as ``train_ppo_torch.py --arch drl_long`` trains it.

Usage:
  python scripts/eval_drl_long_torch.py CKPT.npz [--agents 2] [--cases 500]
      [--steps 250] [--device cuda|cpu]

  (the shipped net: gym_collision_avoidance_torch/models/weights/drl_long_2agent_rvo_tpu.npz)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def evaluate_drl_long(ckpt, agents=2, cases=500, steps=250, device=None):
    """Run the evaluation; ``device=None`` means CUDA.

    Returns ``{"at_goal", "collision", "timeout"}``, agent 0's flags per
    case (numpy bool ``[E]``: ``is_at_goal``, ``was_in_collision_already``,
    ``ran_out_of_time``), and the final ``pos`` ``[E, A, 2]``.
    """
    import torch

    from gym_collision_avoidance_torch.core.device import resolve_device
    from gym_collision_avoidance_torch.env import autoreset
    from gym_collision_avoidance_torch.env.step import env_reset, env_step
    from gym_collision_avoidance_torch.harness import paths
    from gym_collision_avoidance_torch.maps.grid import reciprocal
    from gym_collision_avoidance_torch.models import drl_long

    device = resolve_device(device)
    path = paths.drl_long_eval_path(agents, cases, device)
    net = drl_long.load_params(ckpt, device=device)
    cfg, keys, cells = path.cfg, path.states_in_obs, path.static_cells
    E, f32 = path.num_envs, torch.float32
    others = torch.zeros((E, agents - 1, 2), dtype=f32, device=device)
    # the script's `scan / 6.0` is a product with 1/6 in its compiled scan
    inv6 = reciprocal(6.0, f32)

    state = autoreset.state_from_case(cfg, path.pool, path.policy_id, device=device)
    state, obs = env_reset(state, cfg, path.sensors, keys, None, cells)
    with torch.no_grad():
        for _ in range(steps):
            scal = torch.stack([obs[k][:, 0, 0] for k in keys[:4]], dim=-1)
            scan = obs["laserscan"][:, 0] * inv6 - 0.5
            mean, _log_std, _value = drl_long.forward_actor_critic(net, scan, scal[:, 0:2],
                                                                   scal[:, 2:4])
            ext = torch.cat([mean.to(f32)[:, None, :], others], dim=1)
            state, obs, _rew, _game_over, _info = env_step(state, ext, cfg, None, path.active,
                                                           path.sensors, keys, None, cells)
    return {"at_goal": state.is_at_goal[:, 0].cpu().numpy(),
            "collision": state.was_in_collision_already[:, 0].cpu().numpy(),
            "timeout": state.ran_out_of_time[:, 0].cpu().numpy(),
            "pos": state.pos.cpu().numpy()}


def outcome_lines(name, agents, out):
    """The two lines ``scripts/eval_drl_long.py`` prints."""
    at_goal, coll, timeout = out["at_goal"], out["collision"], out["timeout"]
    success = at_goal & ~coll
    return (f"{name} on the frozen {agents}-agent {len(at_goal)}-case suite "
            f"(learner=greedy DRL-Long net, others=RVO):",
            f"  success {100 * success.mean():.1f}%  collision {100 * coll.mean():.1f}%  "
            f"timeout/stuck {100 * (timeout & ~coll & ~at_goal).mean():.1f}%")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--cases", type=int, default=500)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = evaluate_drl_long(args.ckpt, args.agents, args.cases, args.steps, args.device)
    for line in outcome_lines(os.path.basename(args.ckpt), args.agents, out):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
