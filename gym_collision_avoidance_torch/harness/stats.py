"""Episode-outcome statistics (port of
:mod:`gym_collision_avoidance_tpu.harness.stats`).

Mirrors the reference's ``run_episode`` stats block
(``experiments/src/env_utils.py:52-88``): collision = any agent in
collision, all_at_goal = every agent at goal, any_stuck = some agent
neither.  The reduction runs over the last (agent) axis, so ``[E, A]``
inputs give ``[E]`` flags.
"""

from __future__ import annotations

import torch


def outcome_flags(in_collision, is_at_goal, valid=None):
    """(collision, all_at_goal, any_stuck); ``valid`` masks padded slots,
    which count as neither colliding, at goal nor stuck."""
    if valid is None:
        valid = torch.ones_like(in_collision, dtype=torch.bool)
    in_c = in_collision & valid
    at_g = is_at_goal & valid
    return (torch.any(in_c, dim=-1), torch.all(at_g | ~valid, dim=-1),
            torch.any(~in_c & ~at_g & valid, dim=-1))
