"""Plain reference of the GA3C-CADRL policy (Everett et al., IROS 2018,
arXiv:1805.01956; upstream ``envs/policies/GA3C_CADRL/network.py`` and
``GA3CCADRLPolicy.py:49-84``), read from the shipped ``.npz`` checkpoint.

The net: the raw obs ``[num_others, dist_to_goal, heading_ego, pref_speed,
radius, others x 7]`` normalised by the checkpoint's ``input_avg`` and
``input_std`` (as a product with the reciprocal), an LSTMCell(64) over the
other-agent slots with ``dynamic_rnn``'s copy-through past the sequence
length, three Dense(256)+ReLU layers and the 11 action logits; the action is
the argmax, its speed scaled by ``pref_speed``.  The same trunk, with a
value head and a dividing normalisation, is the PPO recipe's trained net
(``train_net``).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import sim

HIDDEN = 64
DENSE = (256, 256, 256)
NUM_ACTIONS = 11
NAMES = ("input_avg", "input_std", "lstm_kernel", "lstm_bias", "layer1_kernel", "layer1_bias",
         "layer2_kernel", "layer2_bias", "fc1_kernel", "fc1_bias", "logits_p_kernel",
         "logits_p_bias")


TRAIN_LEAVES = NAMES + ("logits_v_kernel", "logits_v_bias")


def _read(path: str, names, device) -> dict:
    with np.load(path) as z:
        return {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device) for k in names}


def load(path: str, device) -> dict:
    return _read(path, NAMES, device)


def load_train(path: str, device) -> dict:
    """The trained net's leaves in sorted name order, the order of the
    global norm's sum."""
    return _read(path, sorted(TRAIN_LEAVES), device)


def flops(rows: int, num_agents: int) -> float:
    """One forward over ``rows`` agents of envs with ``num_agents`` agents
    (a multiply-add two operations; gates and activations left out): the
    LSTM over the A - 1 slots that can hold an other agent (input 7 + state
    64 -> 4 x 64 gates each), then 68 -> 256 -> 256 -> 256 -> 11 (+1 value
    head)."""
    lstm = (num_agents - 1) * (7 + HIDDEN) * 4 * HIDDEN
    widths = (4 + HIDDEN,) + DENSE
    dense = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    heads = DENSE[-1] * (NUM_ACTIONS + 1)
    return 2.0 * rows * (lstm + dense + heads)


def output_error(program, reference):
    """The action probabilities' error, absolute (they lie in [0, 1])."""
    return (program - reference).abs()


def actions_table(dtype, device):
    """The 11 (speed factor, heading change) actions (network.py:7-16)."""
    def grid(speed, step):
        return np.mgrid[speed:speed + 0.1:0.5, -np.pi / 6:np.pi / 6 + 0.01:step].reshape(2, -1).T

    a = np.vstack([grid(1.0, np.pi / 12), grid(0.5, np.pi / 6), grid(0.0, np.pi / 6)])
    return torch.as_tensor(a, dtype=dtype, device=device)


def logits(w: dict, s: dict) -> torch.Tensor:
    """``[E * A, 11]`` action logits of every agent of the states ``s``."""
    E, A = s["pos"].shape[:2]
    N, K = E * A, s["sensed_others"].shape[2]
    f32 = torch.float32
    if 5 + 7 * K != w["input_avg"].shape[0]:
        raise ValueError("the reference models the checkpoint's own slot count only")
    scalars = torch.stack([s["num_other_agents_observed"].to(f32), s["dist_to_goal"].to(f32),
                           s["heading_ego_frame"].to(f32), s["pref_speed"].to(f32),
                           s["radius"].to(f32)], dim=-1).reshape(N, 5)
    T = min(K, A - 1)     # at most A - 1 others are visible; later slots copy through
    others = s["sensed_others"][:, :, :T].to(f32).reshape(N, T, 7)
    avg, std = w["input_avg"], w["input_std"]
    sn = (scalars - avg[:5]) * torch.reciprocal(std[:5])
    on = (others - avg[5:].reshape(-1, 7)[:T]) * torch.reciprocal(std[5:].reshape(-1, 7)[:T])
    seq_len = sn[:, 0].to(torch.int32)
    c = h = torch.zeros((N, HIDDEN), dtype=f32, device=sn.device)
    x_gates = torch.matmul(on, w["lstm_kernel"][:7]) + w["lstm_bias"]
    k_h = w["lstm_kernel"][7:]
    for t in range(T):
        gates = x_gates[:, t] + torch.matmul(h, k_h)
        i, j, f, o = torch.split(gates, HIDDEN, dim=-1)
        new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        keep = (t < seq_len)[:, None]
        c, h = torch.where(keep, new_c, c), torch.where(keep, new_h, h)
    z = torch.cat([sn[:, 1:5], h], dim=-1)
    z = torch.relu(torch.matmul(z, w["layer1_kernel"]) + w["layer1_bias"])
    z = torch.relu(torch.matmul(z, w["layer2_kernel"]) + w["layer2_bias"])
    z = torch.relu(torch.matmul(z, w["fc1_kernel"]) + w["fc1_bias"])
    return torch.matmul(z, w["logits_p_kernel"]) + w["logits_p_bias"]


def decide(w: dict, s: dict, cfg):
    """``(actions [E, A, 2], scores [E, A, 11], probs [E * A, 11], ranked
    [E, A])``: the argmax action of every agent, the logits its choice
    ranks, the action probabilities that the program's policy computes, and
    which agents' actions are that argmax (all)."""
    del cfg
    E, A = s["pos"].shape[:2]
    lg = logits(w, s)
    probs = torch.softmax(lg, dim=-1)
    idx = torch.argmax(probs, dim=-1)     # GA3CCADRLPolicy takes the argmax of the probabilities
    raw = actions_table(s["pos"].dtype, s["pos"].device)[idx]
    act = torch.stack([s["pref_speed"].reshape(E * A) * raw[:, 0], raw[:, 1]], -1)
    return (act.reshape(E, A, 2), lg.reshape(E, A, -1), probs,
            torch.ones((E, A), dtype=torch.bool, device=lg.device))


def train_net(w: dict, x, num_agents: int):
    """(logits [B, 11], value [B]) of ``[B, 5 + 7 K]`` raw obs rows, the
    normalisation a quotient as the net trains."""
    B = x.shape[0]
    K = (x.shape[1] - 5) // 7
    avg, std = w["input_avg"], w["input_std"]
    sn = (x[:, :5] - avg[:5]) / std[:5]
    T = min(K, num_agents - 1)
    on = ((x[:, 5:].reshape(B, K, 7) - avg[5:].reshape(-1, 7)[:K])
          / std[5:].reshape(-1, 7)[:K])[:, :T]
    seq_len = sn[:, 0].to(torch.int32)
    c = h = torch.zeros((B, HIDDEN), dtype=x.dtype, device=x.device)
    x_gates = torch.matmul(on, w["lstm_kernel"][:7]) + w["lstm_bias"]
    k_h = w["lstm_kernel"][7:]
    for t in range(T):
        gates = x_gates[:, t] + torch.matmul(h, k_h)
        i, j, f, o = torch.split(gates, HIDDEN, dim=-1)
        new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        keep = (t < seq_len)[:, None]
        c, h = torch.where(keep, new_c, c), torch.where(keep, new_h, h)
    z = torch.cat([sn[:, 1:5], h], dim=-1)
    z = torch.relu(torch.matmul(z, w["layer1_kernel"]) + w["layer1_bias"])
    z = torch.relu(torch.matmul(z, w["layer2_kernel"]) + w["layer2_bias"])
    z = torch.relu(torch.matmul(z, w["fc1_kernel"]) + w["fc1_bias"])
    logits = torch.matmul(z, w["logits_p_kernel"]) + w["logits_p_bias"]
    return logits, (torch.matmul(z, w["logits_v_kernel"]) + w["logits_v_bias"])[:, 0]


def to_actions(s: dict, act):
    """The env's ``[E, A, 2]`` actions of the sampled indices ``act``
    ``[E * A, 1]``: LearningPolicyGA3C's external action."""
    E, A = s["pos"].shape[:2]
    ext = torch.cat([act, torch.zeros_like(act)], dim=-1).to(s["pos"].dtype).reshape(E, A, 2)
    return sim.ga3c_external(s, ext, actions_table(s["pos"].dtype, s["pos"].device))
