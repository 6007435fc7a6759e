"""Plain reference of the SARL policy: CrowdNav's attention-pooling value net
(Chen, Liu, Kreiss, Alahi, ICRA 2019, arXiv:1809.08835;
``crowd_nav/policy/sarl.py``, ``configs/policy.config`` ``[sarl]``) inside
``MultiHumanRL.predict``'s one-step lookahead in its eval phase, on dict
states, in the states' dtype.

Each agent scores 81 holonomic candidates (the stop, then 16 rotations
2 pi m / 16 by 5 speeds ``v_pref (e^((k+1)/5) - 1) / (e - 1)``): its next
position ``p + a dt``, each other moved on at its velocity, every (candidate,
other) joint state rotated into the goal frame (``cadrl.py:rotate``), the
value net run over them (mlp1 13 -> 150 -> 100, mlp2 100 -> 100 -> 50, the
global state the mean of mlp1's outputs, attention over ``[e_j, m]``
200 -> 100 -> 100 -> 1, the masked softmax with no maximum subtracted, mlp3
over the ego's 6 features and the pooled 50, 56 -> 150 -> 100 -> 100 -> 1),
CrowdNav's reward, and the first argmax of ``reward + 0.9^(dt v_pref) V``.

Departures from CrowdNav, which the configuration's ``assumed`` lists:

* every agent plans, against every other valid agent within the sensing
  horizon (CrowdNav's robot against its humans); an absent other is left
  out of the global mean, the softmax's sum and the reward, and a row with
  no other pools nothing; an invalid agent sees no other;
* the lookahead step is the env's ``dt``, each agent's candidates scale its
  own ``v_pref``, and the tables of speeds, cosines and sines are computed
  in float64 and rounded once to the states' dtype;
* the chosen velocity becomes the unicycle env's (speed, heading change to
  its direction), the stop (0, 0); an agent within its radius of its goal
  stops (``reach_destination``);
* the weights are the repository's seeded init at the published widths, not
  a trained CrowdNav checkpoint.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from perfbench.reference.sim import norm2, sqrt_rn, wrap

GAMMA = 0.9
NUM_ROTATIONS = 16
NUM_SPEEDS = 5
NUM_CANDIDATES = 1 + NUM_ROTATIONS * NUM_SPEEDS
SELF_DIM = 6
# (input, output) of each layer, by CrowdNav's state-dict names
MLP1 = (("mlp1.0", 13, 150), ("mlp1.2", 150, 100))
MLP2 = (("mlp2.0", 100, 100), ("mlp2.2", 100, 50))
ATTENTION = (("attention.0", 200, 100), ("attention.2", 100, 100), ("attention.4", 100, 1))
MLP3 = (("mlp3.0", 56, 150), ("mlp3.2", 150, 100), ("mlp3.4", 100, 100), ("mlp3.6", 100, 1))


def load(path: str, device, dtype=torch.float32) -> dict:
    with np.load(path) as z:
        return {k: torch.as_tensor(np.asarray(z[k]), dtype=dtype, device=device)
                for k in z.files}


def flops(rows: int, num_agents: int) -> float:
    """The value net over the 81 candidates of ``rows`` agents with
    ``num_agents - 1`` others each (a multiply-add two operations), at the
    least any implementation needs: per pair mlp1, mlp2, the attention's
    layers with the first one's half over ``e_j``; per candidate that
    layer's half over the global state, once, and mlp3.  The lookahead's
    geometry and the pooling's sums are left out."""
    first = ATTENTION[0]
    per_pair = sum(i * o for _, i, o in MLP1 + MLP2 + ATTENTION) - (first[1] // 2) * first[2]
    per_row = (first[1] // 2) * first[2] + sum(i * o for _, i, o in MLP3)
    return 2.0 * rows * NUM_CANDIDATES * ((num_agents - 1) * per_pair + per_row)


def output_error(program, reference):
    """The raw candidate values' error, relative."""
    return (program - reference).abs() / (1.0 + reference.abs())


def _mlp(w: dict, layers, x, last_relu=False):
    for i, (name, _, _) in enumerate(layers):
        x = F.linear(x, w[name + ".weight"], w[name + ".bias"])
        if i < len(layers) - 1 or last_relu:
            x = torch.relu(x)
    return x


def value_net(w: dict, pairs, present, self_state):
    """V of ``[R, P, 13]`` rotated pairs with ``present`` ``[R, P]`` and the
    rows' ``[R, 6]`` ego features (``ValueNetwork.forward``)."""
    R, P = pairs.shape[:2]
    e = _mlp(w, MLP1, pairs, last_relu=True)                               # [R, P, 100]
    h = _mlp(w, MLP2, e)                                                   # [R, P, 50]
    mask = present[..., None].to(e.dtype)
    count = torch.clamp(mask.sum(dim=1), min=1.0)
    global_state = (e * mask).sum(dim=1) / count                           # [R, 100]
    att_in = torch.cat([e, global_state[:, None, :].expand(R, P, e.shape[-1])], dim=-1)
    scores = _mlp(w, ATTENTION, att_in)[..., 0]                            # [R, P]
    scores_exp = torch.where(present & (scores != 0), torch.exp(scores),
                             torch.zeros_like(scores))
    total = scores_exp.sum(dim=1, keepdim=True)
    weights = torch.where(total > 0, scores_exp / torch.where(total > 0, total, 1.0),
                          torch.zeros_like(scores_exp))
    pooled = (weights[..., None] * h).sum(dim=1)                           # [R, 50]
    return _mlp(w, MLP3, torch.cat([self_state, pooled], dim=-1))[..., 0]


def _tables(dtype, device):
    k = np.arange(1, NUM_SPEEDS + 1)
    scales = (np.exp(k / NUM_SPEEDS) - 1.0) / (np.e - 1.0)
    rot = np.linspace(0.0, 2.0 * np.pi, NUM_ROTATIONS, endpoint=False)
    return tuple(torch.as_tensor(t, dtype=dtype, device=device)
                 for t in (scales, np.cos(rot), np.sin(rot), rot))


def _lookahead(s: dict, cfg):
    """Every agent's candidates and their pairs: ``(pairs [E, A, 81, P, 13],
    present [E, A, P], self_state [E, A, 81, 6], reward [E, A, 81], speed
    [E, A, 81])``."""
    dt = cfg.dt
    pos, vel, r, pref = s["pos"], s["vel"], s["radius"], s["pref_speed"]
    A = pos.shape[1]
    others = torch.tensor([[j for j in range(A) if j != h] for h in range(A)],
                          dtype=torch.long, device=pos.device).reshape(A, A - 1)
    opos, ovel, orad = pos[:, others], vel[:, others], r[:, others]       # [E, A, P, ...]
    rel = opos - pos[:, :, None]
    present = (s["valid"][:, :, None] & s["valid"][:, others]
               & (norm2(rel) <= cfg.sensing_horizon))

    scales, cos, sin, _ = _tables(pos.dtype, pos.device)
    zero = torch.zeros_like(pref)[..., None]
    speed5 = pref[..., None, None] * scales                                 # [E, A, 1, 5]
    speed16 = speed5.expand(*pref.shape, NUM_ROTATIONS, NUM_SPEEDS)
    speed = torch.cat([zero, speed16.flatten(-2)], dim=-1)                 # [E, A, 81]
    vx = torch.cat([zero, (speed16 * cos[:, None]).flatten(-2)], dim=-1)
    vy = torch.cat([zero, (speed16 * sin[:, None]).flatten(-2)], dim=-1)

    px = pos[..., 0, None] + vx * dt
    py = pos[..., 1, None] + vy * dt
    gx, gy = s["goal"][..., 0, None] - px, s["goal"][..., 1, None] - py
    rot = torch.atan2(gy, gx)
    c, sn = torch.cos(rot), torch.sin(rot)
    dg = sqrt_rn(gx * gx + gy * gy)

    shape = (*px.shape, A - 1)                                              # [E, A, 81, P]
    ox = (opos[..., 0] + ovel[..., 0] * dt)[:, :, None, :]
    oy = (opos[..., 1] + ovel[..., 1] * dt)[:, :, None, :]
    ovx, ovy = ovel[..., 0][:, :, None, :], ovel[..., 1][:, :, None, :]
    r1 = orad[:, :, None, :].expand(shape)
    rr = r[..., None, None].expand(shape)
    dx, dy = ox - px[..., None], oy - py[..., None]
    da = sqrt_rn(dx * dx + dy * dy)
    c4, s4 = c[..., None], sn[..., None]

    self_state = torch.stack([dg, pref[..., None].expand_as(dg), torch.zeros_like(dg),
                              r[..., None].expand_as(dg), vx * c + vy * sn, vy * c - vx * sn],
                             dim=-1)
    pair = torch.stack([dx * c4 + dy * s4, dy * c4 - dx * s4,
                        (ovx * c4 + ovy * s4).expand(shape), (ovy * c4 - ovx * s4).expand(shape),
                        r1, da, rr + r1], dim=-1)
    pairs = torch.cat([self_state[..., None, :].expand(*shape, SELF_DIM), pair], dim=-1)

    # MultiHumanRL.compute_reward over the present others
    gap = da - rr - r1
    there = present[:, :, None, :]
    collision = (there & (gap < 0)).any(dim=-1)
    dmin = torch.where(there, gap, torch.full_like(gap, math.inf)).amin(dim=-1)
    reward = torch.zeros_like(dg)
    reward = torch.where(dmin < 0.2, (dmin - 0.2) * 0.5 * dt, reward)
    reward = torch.where(dg < r[..., None], torch.ones_like(dg), reward)
    reward = torch.where(collision, torch.full_like(dg, -0.25), reward)
    return pairs, present, self_state, reward, speed


def tie_scores(values):
    """``values`` with every candidate after the first maximum that ties it
    exactly put one ulp below it.  The 81 candidates are distinct actions and
    the argmax takes the first maximum, so a later candidate tied with the
    best is the runner-up at no distance: the judge's margin (the gap to the
    next best distinct score, ``perfbench/check.py:margins``) then reads that
    ulp and not the gap to the next value down.  Exact ties are rare but
    occur: where every unit of one of the value net's hidden layers is off,
    V is that layer's constant over a region of candidates."""
    best = torch.argmax(values, dim=-1, keepdim=True)
    later = torch.arange(values.shape[-1], device=values.device) > best
    tied = later & (values == torch.gather(values, -1, best))
    return torch.where(tied, torch.nextafter(values, torch.full_like(values, -math.inf)),
                       values)


def decide(w: dict, s: dict, cfg, envs_per_block: int = 256):
    """``(actions [E, A, 2], scores [E, A, 81], raw [E, A, 81], ranked
    [E, A])``: every agent's action, the candidate values its argmax ranks
    (with exact ties after the first maximum an ulp below it,
    :func:`tie_scores`), the value net's raw outputs, and whether the argmax
    chose the action (not the stop of an agent at its goal).
    ``envs_per_block`` envs at a time, so that the net's ``[rows, P, 200]``
    intermediates stay small."""
    E = s["pos"].shape[0]
    outs = []
    for e0 in range(0, E, envs_per_block):
        sb = {k: v[e0:e0 + envs_per_block] for k, v in s.items()}
        pairs, present, self_state, reward, speed = _lookahead(sb, cfg)
        Eb, A = sb["pos"].shape[:2]
        R = Eb * A * NUM_CANDIDATES
        raw = value_net(w, pairs.reshape(R, A - 1, -1),
                        present[:, :, None, :].expand(Eb, A, NUM_CANDIDATES, A - 1)
                        .reshape(R, A - 1),
                        self_state.reshape(R, SELF_DIM)).reshape(Eb, A, NUM_CANDIDATES)
        values = reward + torch.pow(GAMMA, cfg.dt * sb["pref_speed"])[..., None] * raw
        best = torch.argmax(values, dim=-1)
        rotations = _tables(speed.dtype, speed.device)[3]
        heading = rotations[torch.clamp(best - 1, min=0) // NUM_SPEEDS]
        chosen = torch.gather(speed, -1, best[..., None])[..., 0]
        action = torch.stack([chosen, wrap(heading - sb["heading"])], dim=-1)
        arrived = norm2(sb["goal"] - sb["pos"]) < sb["radius"]
        stop = (best == 0) | arrived
        action = torch.where(stop[..., None], torch.zeros_like(action), action)
        outs.append((action, tie_scores(values), raw, ~arrived))
    return tuple(torch.cat(parts) for parts in zip(*outs))
