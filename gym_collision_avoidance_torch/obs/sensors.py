"""The other-agents sensor (port of
``gym_collision_avoidance_tpu/obs/sensors.py:other_agents_states``).

Replicates ``OtherAgentsStatesSensor.sense`` + ``get_clipped_sorted_inds``
(OtherAgentsStatesSensor.py:20-144) over ``[E, A]`` batches: the
``round(d, 2)`` key, the stable lexicographic order, the sensing horizon
and the ``closest`` fallback.  The JAX package's one-hot masked sums that
pick each slot's row become an index gather here.  The laserscan and the
occupancy grid come with ROADMAP.md §1 item 12.
"""

from __future__ import annotations

import torch

from gym_collision_avoidance_torch import config as cfg_mod
from gym_collision_avoidance_torch.core import maths


def _lex_rank_masked(keys, idx, count_mask):
    """Stable lexicographic rank of each entry of the last axis, counting
    only ``count_mask``-True competitors (``sensors.py:1091-1116``).

    ``keys`` is a tuple of ``[..., N]`` tensors, primary first; ties beyond
    the keys break by index, as ``np.lexsort`` does.  Pairwise O(N^2): the
    main path has N = 4.
    """
    cmp = idx[:, None] > idx[None, :]                     # [N, N]: j before i
    for k in reversed(keys):
        less = k[..., :, None] > k[..., None, :]          # k_j < k_i
        eq = k[..., :, None] == k[..., None, :]
        cmp = less | (eq & cmp)
    return torch.sum(cmp & count_mask[..., None, :], dim=-1)


def other_agents_states(state, cfg):
    """Sense the K closest other agents for every host agent.

    Returns:
        (rows [E, A, K, 7], closest [E, A, 7], counts [E, A] int32): the
        7-tuple is [p_parallel_ego, p_orthog_ego, v_parallel_ego,
        v_orthog_ego, other_radius, combined_radius, dist_2_other]
        (OtherAgentsStatesSensor.py:128-134); empty slots are zero;
        ``closest`` keeps its previous value when nothing is visible.
    """
    E, A = state.pos.shape[:2]
    K = cfg.max_num_other_agents_observed
    device = state.pos.device

    # [E, A_host, A_other] relative quantities, in the JAX package's order.
    pos, vel = state.pos, state.vel
    rel_x = pos[:, None, :, 0] - pos[:, :, None, 0]
    rel_y = pos[:, None, :, 1] - pos[:, :, None, 1]
    dist_centers = torch.sqrt(rel_x * rel_x + rel_y * rel_y)
    prll_x, prll_y = state.ref_prll[..., 0, None], state.ref_prll[..., 1, None]
    orth_x, orth_y = state.ref_orth[..., 0, None], state.ref_orth[..., 1, None]
    p_par = rel_x * prll_x + rel_y * prll_y
    p_orth = rel_x * orth_x + rel_y * orth_y
    v_par = vel[:, None, :, 0] * prll_x + vel[:, None, :, 1] * prll_y
    v_orth = vel[:, None, :, 0] * orth_x + vel[:, None, :, 1] * orth_y
    other_r = state.radius[:, None, :].expand(E, A, A)
    combined_r = state.radius[:, :, None] + state.radius[:, None, :]
    d2other = dist_centers - combined_r

    eye = torch.eye(A, dtype=torch.bool, device=device)
    # Agents beyond the sensing horizon are dropped
    # (OtherAgentsStatesSensor.py:90-92).
    visible = ~eye & state.valid[:, None, :] & (dist_centers <= cfg.sensing_horizon)

    # Sort keys (OtherAgentsStatesSensor.py:103); torch.round is
    # round-half-even, like jnp.round.  The divisor is a tensor because
    # CUDA turns division by a Python scalar into a multiply by its
    # reciprocal, which would make the card's keys differ from the CPU's.
    hundred = torch.full((), 100.0, dtype=d2other.dtype, device=device)
    d_rounded = torch.round(d2other * 100.0) / hundred

    method = cfg.agent_sorting_method
    idx = torch.arange(A, device=device)
    if method == cfg_mod.SORT_TIME_TO_IMPACT:
        tti = maths.compute_time_to_impact(
            pos[:, :, None, :], pos[:, None, :, :],
            vel[:, :, None, :], vel[:, None, :, :], combined_r,
        )
        clip_keys = (-tti, -d_rounded, p_orth)
    elif method in (cfg_mod.SORT_CLOSEST_FIRST, cfg_mod.SORT_CLOSEST_LAST):
        clip_keys = (d_rounded, p_orth)
    else:
        raise ValueError(f"unknown agent_sorting_method {method}")

    rank = _lex_rank_masked(clip_keys, idx, visible)          # [E, A, A]
    selected = visible & (rank < K)
    # Re-sort the clipped K by the final scheme (":41-50"); closest_first
    # and time_to_impact re-sort by the clip key, a no-op on a stable order.
    if method == cfg_mod.SORT_CLOSEST_LAST:
        rank = _lex_rank_masked((-d_rounded, p_orth), idx, selected)

    # Slot k of host h holds the selected agent of rank k: a gather.
    slot = torch.arange(K, device=device)
    onehot = (rank[:, :, None, :] == slot[:, None]) & selected[:, :, None, :]  # [E, A, K, A]
    has = onehot.any(dim=-1)                                              # [E, A, K]
    src = onehot.to(torch.uint8).argmax(dim=-1)                           # [E, A, K]
    fields = torch.stack((p_par, p_orth, v_par, v_orth, other_r, combined_r, d2other),
                         dim=-1)                                          # [E, A, A, 7]
    rows = torch.gather(fields, 2, src[..., None].expand(E, A, K, 7))
    rows = torch.where(has[..., None], rows, torch.zeros_like(rows))

    counts = torch.clamp(visible.sum(dim=-1), max=K).to(torch.int32)
    closest = torch.where((counts > 0)[..., None], rows[:, :, 0, :],
                          state.other_agent_states)
    return rows, closest, counts
