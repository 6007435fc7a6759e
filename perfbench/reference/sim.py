"""Plain reference of the env step that the serving cells run: a frozen copy,
in plain PyTorch on dicts of ``[E, A, ...]`` tensors, of the port's plain
step for what those cells use (unicycle dynamics, no static map, the
other-agents sensor, the default observation keys, an internal policy on
every agent) and of the auto-reset pick.

Nothing here imports the program: the harness hands this module the
program's states as ``{field: tensor}`` dicts and judges what comes back.
Sources of each piece (the upstream simulator's lines) are those the port
cites beside the same code.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_TWO_PI = 2.0 * math.pi
NUM_PAST = 2
UNICYCLE = 0
# policy ids of the upstream registry
LEARNING, LEARNING_GA3C = 3, 4


@dataclasses.dataclass(frozen=True)
class Config:
    """The env's settings, upstream ``envs/config.py`` defaults; a
    configuration file's ``env`` object overrides them by name."""

    dt: float = 0.2
    near_goal_threshold: float = 0.2
    max_time_ratio: float = 2.0
    reward_at_goal: float = 1.0
    reward_collision_with_agent: float = -0.25
    reward_collision_with_wall: float = -0.25
    reward_getting_close: float = -0.1
    reward_time_step: float = 0.0
    reward_wiggly_behavior: float = 0.0
    wiggly_behavior_threshold: float = np.inf
    getting_close_range: float = 0.2
    sensing_horizon: float = np.inf
    max_num_other_agents_observed: int = 3
    agent_sorting_method: str = "closest_first"
    done_mode: str = "evaluate"
    dtype: str = "float32"

    @staticmethod
    def from_env(env: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(Config)}
        unknown = set(env) - names
        if unknown:
            raise ValueError(f"the reference does not model {sorted(unknown)}")
        return Config(**env)

    @property
    def torch_dtype(self):
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]


# ---------------------------------------------------------------- maths


def sqrt_rn(x):
    """IEEE square root: CUDA's ``sqrt`` is; on the CPU numpy's is."""
    if x.device.type != "cpu" or x.dtype not in (torch.float32, torch.float64):
        return torch.sqrt(x)
    a = x.detach().numpy()
    return torch.from_numpy(np.sqrt(a, out=np.empty_like(a)))


def wrap(a):
    for _ in range(3):
        a = torch.where(a >= math.pi, a - _TWO_PI, a)
        a = torch.where(a < -math.pi, a + _TWO_PI, a)
    return a


def norm2(v):
    return sqrt_rn(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def ego_frame(pos, goal, heading, vel):
    """(ref_prll, ref_orth, dist_to_goal, heading_ego, vel_ego)
    (Agent.get_ref, Dynamics.update_ego_frame)."""
    gd = goal - pos
    dist = norm2(gd)
    ref_prll = torch.where((dist > 1e-8)[..., None], gd / torch.clamp(dist, min=1e-30)[..., None],
                           gd)
    ref_orth = torch.stack([-ref_prll[..., 1], ref_prll[..., 0]], dim=-1)
    heading_ego = wrap(heading - torch.atan2(ref_prll[..., 1], ref_prll[..., 0]))
    speed = norm2(vel)
    vel_ego = torch.stack([speed * torch.cos(heading_ego), speed * torch.sin(heading_ego)], -1)
    return ref_prll, ref_orth, dist, heading_ego, vel_ego


# ---------------------------------------------------------------- state


def init_states(cfg: Config, case: np.ndarray, policy_id, device, rng=(0, 0)) -> dict:
    """Fresh states of ``[E, A, 6]`` case rows (Agent.reset, heading at the
    goal), before the first sensing; ``rng`` the PRNG key words every env
    carries."""
    dt_ = cfg.torch_dtype
    c = torch.as_tensor(np.asarray(case), dtype=dt_, device=device)
    pos, goal, pref, radius = c[..., 0:2], c[..., 2:4], c[..., 4], c[..., 5]
    E, A = pos.shape[:2]
    gd = goal - pos
    heading = torch.atan2(gd[..., 1], gd[..., 0])
    vel = torch.zeros((E, A, 2), dtype=dt_, device=device)
    time_remaining = torch.clamp(cfg.max_time_ratio * (norm2(gd) - cfg.near_goal_threshold)
                                 / pref, min=cfg.dt)
    ref_prll, ref_orth, dist, heading_ego, vel_ego = ego_frame(pos, goal, heading, vel)

    def z(*shape, t=dt_):
        return torch.zeros(shape, dtype=t, device=device)

    K = cfg.max_num_other_agents_observed
    return dict(
        pos=pos, vel=vel, speed=z(E, A), heading=heading.contiguous(), delta_heading=z(E, A),
        goal=goal, radius=radius, pref_speed=pref, ref_prll=ref_prll, ref_orth=ref_orth,
        dist_to_goal=dist, heading_ego_frame=heading_ego, vel_ego_frame=vel_ego,
        past_actions=z(E, A, NUM_PAST, 2), past_vel=z(E, A, NUM_PAST, 2), turning_dir=z(E, A),
        time_remaining=time_remaining, t=z(E, A), step_num=z(E, A, t=torch.int32),
        is_at_goal=z(E, A, t=torch.bool), was_at_goal_already=z(E, A, t=torch.bool),
        in_collision=z(E, A, t=torch.bool), was_in_collision_already=z(E, A, t=torch.bool),
        ran_out_of_time=z(E, A, t=torch.bool), is_done=z(E, A, t=torch.bool),
        other_agent_states=z(E, A, 7), sensed_others=z(E, A, K, 7),
        num_other_agents_observed=z(E, A, t=torch.int32),
        laserscan_history=z(E, A, 0, 0), laserscan_count=z(E, A, t=torch.int32),
        policy_id=torch.as_tensor(np.asarray(policy_id), dtype=torch.int32,
                                  device=device).expand(E, A).contiguous(),
        dynamics_id=z(E, A, t=torch.int32), valid=torch.ones((E, A), dtype=torch.bool,
                                                              device=device),
        episode_step=z(E, t=torch.int32),
        rng=torch.tensor(rng, dtype=torch.int64, device=device).expand(E, 2).contiguous(),
    )


# ---------------------------------------------------------------- step


def _turning_dir(turning_dir, heading_cmd):
    near_zero = torch.abs(turning_dir) < 1e-5
    opposite = turning_dir * heading_cmd < 0
    return torch.where(near_zero, 0.11 * torch.sign(heading_cmd),
                       torch.where(opposite,
                                   torch.clamp(-turning_dir + heading_cmd, -math.pi, math.pi),
                                   torch.sign(turning_dir)
                                   * torch.clamp(torch.abs(turning_dir) - 0.1, min=0.0)))


def take_actions(s: dict, actions, cfg: Config) -> dict:
    """Agent.take_action on every agent (envs/agent.py:192-241) under
    UnicycleDynamics.step (UnicycleDynamics.py:27-47)."""
    if bool((s["dynamics_id"] != UNICYCLE).any()):
        raise ValueError("the reference models unicycle dynamics only")
    dt = cfg.dt
    frozen = s["is_at_goal"] | s["ran_out_of_time"] | s["in_collision"]
    active = ~frozen & s["valid"]
    av, vv = active[..., None], s["valid"][..., None]
    out = dict(s)
    out["was_at_goal_already"] = s["was_at_goal_already"] | (frozen & s["is_at_goal"])
    out["was_in_collision_already"] = s["was_in_collision_already"] | (frozen & s["in_collision"])
    rolled = torch.cat([actions[..., None, :], s["past_actions"][..., :-1, :]], dim=-2)
    out["past_actions"] = torch.where(av[..., None], rolled, s["past_actions"])

    speed_cmd, dheading = actions[..., 0], actions[..., 1]
    heading_new = wrap(dheading + s["heading"])
    c, sn = torch.cos(heading_new), torch.sin(heading_new)
    new_pos = s["pos"] + torch.stack([speed_cmd * c * dt, speed_cmd * sn * dt], dim=-1)
    new_vel = torch.stack([speed_cmd * c, speed_cmd * sn], dim=-1)
    new_dh = wrap(heading_new - s["heading"])
    new_turn = _turning_dir(s["turning_dir"], wrap(actions[..., 1] + s["heading"]))

    pos = torch.where(av, new_pos, s["pos"])
    vel = torch.where(vv, torch.where(av, new_vel, torch.zeros_like(s["vel"])), s["vel"])
    heading = torch.where(active, heading_new, s["heading"])
    out.update(pos=pos, vel=vel, speed=torch.where(active, speed_cmd, s["speed"]),
               heading=heading, delta_heading=torch.where(active, new_dh, s["delta_heading"]),
               turning_dir=torch.where(active, new_turn, s["turning_dir"]))
    ref_prll, ref_orth, dist, heading_ego, vel_ego = ego_frame(pos, s["goal"], heading, vel)
    out.update(ref_prll=torch.where(av, ref_prll, s["ref_prll"]),
               ref_orth=torch.where(av, ref_orth, s["ref_orth"]),
               dist_to_goal=torch.where(active, dist, s["dist_to_goal"]),
               heading_ego_frame=torch.where(active, heading_ego, s["heading_ego_frame"]),
               vel_ego_frame=torch.where(av, vel_ego, s["vel_ego_frame"]))
    diff = pos - s["goal"]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    out["is_at_goal"] = torch.where(active, d2 <= cfg.near_goal_threshold ** 2, s["is_at_goal"])
    past_vel = torch.cat([vel[..., None, :], s["past_vel"][..., :-1, :]], dim=-2)
    out["past_vel"] = torch.where(vv[..., None], past_vel, s["past_vel"])
    time_remaining = torch.where(active, s["time_remaining"] - dt, s["time_remaining"])
    out.update(time_remaining=time_remaining,
               ran_out_of_time=torch.where(active, time_remaining <= 0.0, s["ran_out_of_time"]),
               t=torch.where(active, s["t"] + dt, s["t"]),
               step_num=torch.where(active, s["step_num"] + 1, s["step_num"]))
    return out


def rewards(s: dict, cfg: Config):
    """Pairwise collisions and nearest gaps, reward shaping, the clip and
    the collision latch (collision_avoidance_env.py:394-456) -> (reward
    [E, A], in_collision [E, A])."""
    pos, radius, valid = s["pos"], s["radius"], s["valid"]
    A = pos.shape[-2]
    rel = pos[:, None, :, :] - pos[:, :, None, :]
    dist = sqrt_rn(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
    comb = radius[:, :, None] + radius[:, None, :]
    eye = torch.eye(A, dtype=torch.bool, device=pos.device)
    pair = valid[:, :, None] & valid[:, None, :] & ~eye
    nearest = torch.amin(torch.where(pair, dist - comb, torch.full_like(dist, math.inf)), dim=-1)
    collision = torch.any(pair & (dist <= comb), dim=-1)

    r = torch.full(valid.shape, cfg.reward_time_step, dtype=nearest.dtype, device=pos.device)
    r = torch.where(s["is_at_goal"] & ~s["was_at_goal_already"],
                    torch.full_like(r, cfg.reward_at_goal), r)
    eligible = ~s["is_at_goal"] & ~s["was_in_collision_already"]
    hit = eligible & collision
    r = torch.where(hit, torch.full_like(r, cfg.reward_collision_with_agent), r)
    no_hit = eligible & ~collision
    close = no_hit & (nearest <= cfg.getting_close_range)
    r = torch.where(close, cfg.reward_getting_close - nearest / 2.0, r)
    wiggly = no_hit & (torch.abs(s["past_actions"][..., 0, 1]) > cfg.wiggly_behavior_threshold)
    r = torch.where(wiggly, r + cfg.reward_wiggly_behavior, r)
    possible = [cfg.reward_at_goal, cfg.reward_collision_with_agent, cfg.reward_time_step,
                cfg.reward_collision_with_wall, cfg.reward_wiggly_behavior]
    r = torch.clamp(r, min(possible), max(possible))
    r = torch.where(valid, r, torch.zeros_like(r))
    return r, s["in_collision"] | hit


def lex_rank(keys, idx, count_mask):
    """Stable lexicographic rank over the last axis, counting only
    ``count_mask`` competitors; ties break by index (np.lexsort)."""
    cmp = idx[:, None] > idx[None, :]
    for k in reversed(keys):
        cmp = (k[..., :, None] > k[..., None, :]) | ((k[..., :, None] == k[..., None, :]) & cmp)
    if count_mask is not None:
        cmp = cmp & count_mask[..., None, :]
    return torch.sum(cmp, dim=-1)


def other_agents(s: dict, cfg: Config):
    """OtherAgentsStatesSensor.sense (OtherAgentsStatesSensor.py:20-144):
    (rows [E, A, K, 7], closest [E, A, 7], counts [E, A])."""
    pos, vel = s["pos"], s["vel"]
    E, A = pos.shape[:2]
    K = cfg.max_num_other_agents_observed
    dev = pos.device
    rel_x = pos[:, None, :, 0] - pos[:, :, None, 0]
    rel_y = pos[:, None, :, 1] - pos[:, :, None, 1]
    dist = sqrt_rn(rel_x * rel_x + rel_y * rel_y)
    px, py = s["ref_prll"][..., 0, None], s["ref_prll"][..., 1, None]
    ox, oy = s["ref_orth"][..., 0, None], s["ref_orth"][..., 1, None]
    p_par, p_orth = rel_x * px + rel_y * py, rel_x * ox + rel_y * oy
    v_par = vel[:, None, :, 0] * px + vel[:, None, :, 1] * py
    v_orth = vel[:, None, :, 0] * ox + vel[:, None, :, 1] * oy
    other_r = s["radius"][:, None, :].expand(E, A, A)
    comb = s["radius"][:, :, None] + s["radius"][:, None, :]
    d2other = dist - comb
    eye = torch.eye(A, dtype=torch.bool, device=dev)
    visible = ~eye & s["valid"][:, None, :] & (dist <= cfg.sensing_horizon)
    d_round = torch.round(d2other * 100.0) / torch.full((), 100.0, dtype=d2other.dtype,
                                                         device=dev)
    if cfg.agent_sorting_method not in ("closest_first", "closest_last"):
        raise ValueError(f"the reference models closest_first/last sorting only")
    idx = torch.arange(A, device=dev)
    rank = lex_rank((d_round, p_orth), idx, visible)
    selected = visible & (rank < K)
    if cfg.agent_sorting_method == "closest_last":
        rank = lex_rank((-d_round, p_orth), idx, selected)
    slot = torch.arange(K, device=dev)
    onehot = (rank[:, :, None, :] == slot[:, None]) & selected[:, :, None, :]
    has = onehot.any(dim=-1)
    src = onehot.to(torch.uint8).argmax(dim=-1)
    fields = torch.stack((p_par, p_orth, v_par, v_orth, other_r, comb, d2other), dim=-1)
    rows = torch.gather(fields, 2, src[..., None].expand(E, A, K, 7))
    rows = torch.where(has[..., None], rows, torch.zeros_like(rows))
    counts = torch.clamp(visible.sum(dim=-1), max=K).to(torch.int32)
    closest = torch.where((counts > 0)[..., None], rows[:, :, 0, :], s["other_agent_states"])
    return rows, closest, counts


def sense(s: dict, cfg: Config):
    """The sensor pass and the observation (collision_avoidance_env.py:555-575)."""
    rows, closest, counts = other_agents(s, cfg)
    s = dict(s, other_agent_states=closest, sensed_others=rows,
             num_other_agents_observed=counts)
    dt_ = s["pos"].dtype
    obs = {"is_learning": is_learning(s).to(dt_)[..., None],
           "num_other_agents": counts.to(dt_)[..., None],
           "dist_to_goal": s["dist_to_goal"][..., None],
           "heading_ego_frame": s["heading_ego_frame"][..., None],
           "pref_speed": s["pref_speed"][..., None], "radius": s["radius"][..., None],
           "other_agents_states": rows}
    return s, obs


def is_learning(s: dict):
    return (s["policy_id"] == LEARNING) | (s["policy_id"] == LEARNING_GA3C)


def dones(s: dict, cfg: Config):
    """Done flags and the per-env game over (collision_avoidance_env.py:514-553)."""
    which = s["is_at_goal"] | s["ran_out_of_time"] | s["in_collision"]
    is_done = which | ~s["valid"]
    if cfg.done_mode == "evaluate":
        game_over = torch.all(is_done, dim=-1)
    elif cfg.done_mode == "learning":
        game_over = torch.all(is_done | ~is_learning(s), dim=-1)
    else:
        raise ValueError("the reference models the evaluate and learning done modes")
    return dict(s, is_done=is_done), game_over


def ga3c_external(s: dict, ext, table):
    """LearningPolicyGA3C's action (LearningPolicyGA3C.py:25-27): the index
    ``ext[..., 0]`` into the 11-action table, its speed scaled by
    ``pref_speed``."""
    if bool((s["policy_id"] != LEARNING_GA3C).any()):
        raise ValueError("the reference maps LearningPolicyGA3C's actions only")
    idx = torch.clamp(ext[..., 0].to(torch.int32), 0, 10).long()
    a = table[idx]
    return torch.stack([a[..., 0] * s["pref_speed"], a[..., 1]], dim=-1)


def env_step(s: dict, actions, cfg: Config):
    """One step given every agent's ``[E, A, 2]`` action (done agents'
    zeroed here): (state, obs, rewards, game_over)."""
    actions = torch.where(s["is_done"][..., None], torch.zeros_like(actions), actions)
    actions = actions.to(torch.float32).to(s["pos"].dtype)
    s = take_actions(s, actions, cfg)
    r, in_collision = rewards(s, cfg)
    s = dict(s, in_collision=in_collision)
    s, obs = sense(s, cfg)
    s, game_over = dones(s, cfg)
    s["episode_step"] = s["episode_step"] + 1
    return s, obs, r, game_over


def reset_where_done(s: dict, obs: dict, counter, game_over, fresh: dict, fresh_obs: dict):
    """The auto-reset pick: envs whose episode is over take the fresh state
    of pool case ``counter % N``, keeping their PRNG words; the counter
    advances."""
    pick = (counter % fresh["pos"].shape[0]).long()

    def sel(new, old):
        return torch.where(game_over.reshape((-1,) + (1,) * (old.dim() - 1)), new[pick], old)

    out = {k: (v if k == "rng" else sel(fresh[k], v)) for k, v in s.items()}
    obs = {k: sel(fresh_obs[k], v) for k, v in obs.items()}
    return out, obs, counter + game_over.to(counter.dtype)


def fresh_pool(cfg: Config, pool, policy_id, device):
    """Every pool case's fresh state and first observation."""
    return sense(init_states(cfg, pool, policy_id, device), cfg)
