"""Plain reference of a PPO iteration in self-play (stage 3 of the
curriculum, ``scripts/train_curriculum.sh:25-30``): a rollout of T
auto-reset steps in which every agent samples its action from the net
(Gumbel-max with the benchmark's noise), GAE(lambda), and ``epochs`` passes
over ``num_minibatches`` minibatches of whole env-major sample streams, each
a clipped-surrogate loss (Schulman et al. 2017, arXiv:1707.06347), its
gradients by autograd, a clip by the global norm and one Adam step in
optax's order (``optax.chain(clip_by_global_norm, adam)``).

The net is a reference module's trained form (``train_net``, ``to_actions``;
``perfbench/reference/__init__.py``), every tensor of its checkpoint a leaf,
kept in sorted name order, the order of the global norm's sum.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import sim

B1, B2, EPS = 0.9, 0.999, 1e-8
OBS_KEYS = ("num_other_agents", "dist_to_goal", "heading_ego_frame", "pref_speed", "radius",
            "other_agents_states")


def logp(logits, act):
    ls = torch.log_softmax(logits, dim=-1)
    onehot = (torch.arange(ls.shape[-1], device=ls.device)[None, :]
              == act[:, 0].to(torch.int32)[:, None]).to(ls.dtype)
    return torch.sum(onehot * ls, dim=-1)


def flatten(obs: dict, B: int):
    return torch.cat([obs[k].reshape(B, -1).to(torch.float32) for k in OBS_KEYS], dim=-1)


@torch.no_grad()
def rollout(net, w, s, counter, obs, gumbel, recipe, cfg, fresh, fresh_obs):
    E, A = s["pos"].shape[:2]
    B = E * A
    steps = []
    for t in range(recipe["horizon"]):
        x = flatten(obs, B)
        alive = (~s["is_done"]).reshape(B).to(torch.float32)
        logits, value = net.train_net(w, x, A)
        act = torch.argmax(gumbel[t] + logits, dim=-1)[:, None].to(torch.float32)
        lp = logp(logits, act)
        d_prev = s["dist_to_goal"].to(torch.float32)
        s, obs, r, game_over = sim.env_step(s, net.to_actions(s, act), cfg)
        s, obs, counter = sim.reset_where_done(s, obs, counter, game_over, fresh, fresh_obs)
        go = game_over.to(torch.float32)[:, None]
        shaped = r.to(torch.float32) + recipe["shaping_coef"] * (
            d_prev - s["dist_to_goal"].to(torch.float32)) * (1.0 - go)
        steps.append({"x": x, "act": act, "logp": lp, "value": value, "alive": alive,
                      "reward": shaped.reshape(B),
                      "done": (game_over[:, None] | s["is_done"]).reshape(B)})
    data = {k: torch.stack([st[k] for st in steps]) for k in steps[0]}
    data["last_value"] = net.train_net(w, flatten(obs, B), A)[1]
    return s, counter, obs, data


def gae(rewards, values, dones, last_value, gamma, lam):
    dones = dones.to(rewards.dtype)
    adv = torch.empty_like(rewards)
    g, next_val = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_val * nonterm - values[t]
        g = delta + gamma * lam * nonterm * g
        adv[t] = g
        next_val = values[t]
    return adv, adv + values


def loss_fn(net, w, mb, recipe, num_agents):
    logits, value = net.train_net(w, mb["x"], num_agents)
    ratio = torch.exp(logp(logits, mb["act"]) - mb["logp"])
    adv = mb["adv"]
    eps = recipe["clip_eps"]
    clipped = torch.minimum(torch.maximum(ratio, ratio.new_tensor(1.0 - eps)),
                            ratio.new_tensor(1.0 + eps))
    pg = -torch.minimum(ratio * adv, clipped * adv)
    wt = mb["alive"]
    wsum = torch.clamp_min(torch.sum(wt), 1.0)
    v_err = value - mb["target"]
    v_loss = 0.5 * torch.sum(v_err * v_err * wt) / wsum
    ls = torch.log_softmax(logits, dim=-1)
    ent = torch.sum(-torch.sum(torch.exp(ls) * ls, dim=-1) * wt) / wsum
    return torch.sum(pg * wt) / wsum + recipe["value_coef"] * v_loss - recipe["entropy_coef"] * ent


def adam_step(w: dict, grads: dict, opt: dict, recipe):
    """Clip by the global norm, then one Adam step; ``w`` updated in place."""
    total = None
    for g in grads.values():
        s = torch.sum(g * g)
        total = s if total is None else total + s
    norm = sim.sqrt_rn(total)
    max_norm = recipe["max_grad_norm"]
    grads = {k: torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm)
             for k, g in grads.items()}
    opt["count"] += 1
    bc1 = torch.tensor(np.float32(1) - np.float32(B1) ** np.float32(opt["count"]),
                       device=norm.device)
    bc2 = torch.tensor(np.float32(1) - np.float32(B2) ** np.float32(opt["count"]),
                       device=norm.device)
    with torch.no_grad():
        for k, g in grads.items():
            opt["mu"][k] = (1 - B1) * g + B1 * opt["mu"][k]
            opt["nu"][k] = (1 - B2) * (g * g) + B2 * opt["nu"][k]
            w[k].add_(opt["mu"][k] / bc1 / (sim.sqrt_rn(opt["nu"][k] / bc2) + EPS)
                      * -recipe["lr"])


def iteration(net, w, opt, s, counter, obs, noise, recipe, cfg, fresh, fresh_obs):
    """One PPO iteration of the reference module ``net``'s trained net;
    ``w`` and ``opt`` are updated in place.  Returns
    ``(states, counter, obs, loss)``, the loss the mean over minibatches."""
    A = s["pos"].shape[1]
    s, counter, obs, data = rollout(net, w, s, counter, obs, noise["gumbel"], recipe, cfg,
                                    fresh, fresh_obs)
    adv, target = gae(data["reward"], data["value"], data["done"], data["last_value"],
                      recipe["gamma"], recipe["gae_lambda"])
    em = {"x": data["x"], "act": data["act"], "logp": data["logp"], "adv": adv,
          "target": target, "alive": data["alive"]}
    em = {k: v.transpose(0, 1) for k, v in em.items()}
    B, T = em["x"].shape[:2]
    n_mb = recipe["num_minibatches"]
    losses = []
    for e in range(recipe["epochs"]):
        mbs = {k: v[noise["perm"][e]].reshape((n_mb, (B // n_mb) * T) + v.shape[2:])
               for k, v in em.items()}
        for m in range(n_mb):
            mb = {k: v[m] for k, v in mbs.items()}
            a, wt = mb["adv"], mb["alive"]
            wsum = torch.clamp_min(torch.sum(wt), 1.0)
            d = a - torch.sum(a * wt) / wsum
            var = torch.sum(wt * (d * d)) / wsum
            mb["adv"] = d * torch.reciprocal(sim.sqrt_rn(var + 1e-8))
            leaves = {k: w[k].detach().requires_grad_(True) for k in w}
            loss = loss_fn(net, leaves, mb, recipe, A)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            adam_step(w, grads, opt, recipe)
    return s, counter, obs, sum(losses) / len(losses)


def init_opt(w: dict) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in w.items()},
            "nu": {k: torch.zeros_like(v) for k, v in w.items()}}
