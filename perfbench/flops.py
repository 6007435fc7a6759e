"""Operations and bytes of the benchmark's kernels and nets, counted from
shapes: the algorithm's work, the same whatever implements it.

A multiply-add counts two operations.  Elementwise work beside the products
(activations, the LSTM's gates, the lookahead's geometry) is left out, so a
share of the peak that these counts give is a floor of the achieved rate.
A policy's net is counted by its reference module's ``flops``
(``perfbench/reference/<policy>.py``).
"""

from __future__ import annotations

from perfbench import reference


def net_flops(name: str, rows: int, num_agents: int) -> float:
    """One forward of the net of reference module ``name`` over ``rows``
    agents of envs with ``num_agents`` agents."""
    return reference.module(name).flops(rows, num_agents)


def policy_flops_per_step(config: dict, num_envs: int) -> float:
    """The policy net's operations in one env step of ``num_envs`` envs."""
    A = config["num_agents"]
    return net_flops(config["reference"]["policy"], num_envs * A, A)


def k1_bytes(num_envs: int, num_agents: int) -> int:
    """The bytes that K1 with its reward epilogue needs, each input read once
    and each output written once: ``pos`` [E, A, 2] and ``radius`` (float32),
    five ``[E, A]`` bool flags, the last heading change of ``past_actions``
    (float32) in; ``collision`` and ``in_collision`` (bool), ``nearest`` and
    ``reward`` (float32) out."""
    per_agent_in = 2 * 4 + 4 + 5 * 1 + 4
    per_agent_out = 1 + 4 + 4 + 1
    return num_envs * num_agents * (per_agent_in + per_agent_out)


def k1_flops(num_envs: int, num_agents: int) -> float:
    """K1's arithmetic: per ordered pair a difference (2), a squared norm
    (3), a root (1), the combined radius and the gap (2)."""
    return 8.0 * num_envs * num_agents * num_agents


def k2_bytes(num_envs: int, num_agents: int, laserscan_length: int) -> int:
    """The bytes of any laser scan of ``[E, A]`` agents, each input read once
    and each output written once: each agent's pose (``pos`` [2] and
    ``heading``), ``radius`` (float32) and ``valid`` flag in; its ``[L]``
    float32 ranges out.  The work of the scan whatever implements it: a
    design's own reads (K2's source bands and map) are left out."""
    per_agent_in = 3 * 4 + 4 + 1
    return num_envs * num_agents * (per_agent_in + 4 * laserscan_length)
