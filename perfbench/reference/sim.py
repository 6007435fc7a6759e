"""Plain reference of the env step that the serving cells run: a frozen copy,
in plain PyTorch on dicts of ``[E, A, ...]`` tensors, of the port's plain
step for what those cells use (unicycle dynamics, the other-agents sensor,
an internal policy on every agent; where a configuration's ``world`` names
them, the laserscan sensor with its scan history, and the empty static map
with its wall test) and of the auto-reset pick; and the distances by which
a step's comparisons missed their thresholds (:func:`step_margins`), which
judge a policy with no argmax.

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
SENSORS = ("other_agents_states", "laserscan")
# LaserScanSensor.py:32-39: 60 range samples 0.1 m apart, beams over +-pi/2
LASER_RESOLUTION = 0.1
LASER_MAX_RANGE = 6.0
LASER_SAMPLES = len(np.arange(0.0, LASER_MAX_RANGE, LASER_RESOLUTION))
# cells of the agent-stamped map built at once: the laser runs in blocks of
# envs so that its map fits beside the judged states
MAP_BLOCK_CELLS = 2**27
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
    use_static_map: bool = False
    map_x_width: float = 16.0
    map_y_width: float = 16.0
    map_grid_cell_size: float = 0.1
    laserscan_length: int = 512
    laserscan_num_past: int = 3
    # the sensors of the configuration's world, each on every agent
    sensors: tuple = ("other_agents_states",)

    @staticmethod
    def from_env(env: dict, world: dict | None = None) -> "Config":
        """``env`` overrides the defaults by name; ``world`` (a configuration's
        ``sensors``, ``states_in_obs`` and ``static_map``) names the sensors
        and the map.  Anything the reference does not model raises."""
        names = {f.name for f in dataclasses.fields(Config)} - {"sensors"}
        world = dict(world or {})
        unknown = sorted(set(env) - names) + sorted(
            set(world) - {"sensors", "states_in_obs", "static_map"})
        if unknown:
            raise ValueError(f"the reference does not model {unknown}")
        if world.get("static_map", "empty") != "empty":
            raise ValueError(f"the reference models the empty static map only, not "
                             f"{world['static_map']!r}")
        sensors = tuple(world.get("sensors", ("other_agents_states",)))
        if not all(isinstance(n, str) and n in SENSORS for n in sensors):
            raise ValueError(f"the reference models the sensors {SENSORS} on every agent, "
                             f"not {sensors}")
        cfg = Config(**env, sensors=sensors)
        if "laserscan" in sensors and not cfg.use_static_map:
            raise ValueError("the laserscan sensor needs use_static_map")
        return cfg

    @property
    def torch_dtype(self):
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]

    @property
    def map_shape(self):
        return (int(self.map_y_width / self.map_grid_cell_size),
                int(self.map_x_width / self.map_grid_cell_size))

    def static_cells(self, device):
        """``[S, 2]`` (row, column) of the static map's occupied cells: none,
        on the empty map, the only one modelled."""
        return torch.zeros((0, 2), dtype=torch.int64, device=device)


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
        laserscan_history=(z(E, A, cfg.laserscan_num_past, cfg.laserscan_length)
                           if cfg.use_static_map else z(E, A, 0, 0)),
        laserscan_count=z(E, A, t=torch.int32),
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

    # the wall test (collision_avoidance_env.py:494-506) on map configurations
    wall = wall_hits(s, cfg) if cfg.use_static_map else torch.zeros_like(collision)

    r = torch.full(valid.shape, cfg.reward_time_step, dtype=nearest.dtype, device=pos.device)
    r = torch.where(s["is_at_goal"] & ~s["was_at_goal_already"],
                    torch.full_like(r, cfg.reward_at_goal), r)
    eligible = ~s["is_at_goal"] & ~s["was_in_collision_already"]
    hit = eligible & collision
    hit_wall = eligible & ~collision & wall
    r = torch.where(hit, torch.full_like(r, cfg.reward_collision_with_agent), r)
    r = torch.where(hit_wall, torch.full_like(r, cfg.reward_collision_with_wall), r)
    no_hit = eligible & ~collision & ~wall
    close = no_hit & (nearest <= cfg.getting_close_range)
    r = torch.where(close, cfg.reward_getting_close - nearest / 2.0, r)
    wiggly = no_hit & (torch.abs(s["past_actions"][..., 0, 1]) > cfg.wiggly_behavior_threshold)
    r = torch.where(wiggly, r + cfg.reward_wiggly_behavior, r)
    possible = [cfg.reward_at_goal, cfg.reward_collision_with_agent, cfg.reward_time_step,
                cfg.reward_collision_with_wall, cfg.reward_wiggly_behavior]
    r = torch.clamp(r, min(possible), max(possible))
    r = torch.where(valid, r, torch.zeros_like(r))
    return r, s["in_collision"] | hit | hit_wall


# ---------------------------------------------------------------- map, laser


def reciprocal(value: float, dtype) -> float:
    """``1 / value`` rounded to ``dtype``: the port multiplies by it where
    upstream divides by a map constant (XLA's rewrite of the division)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return float(np_dtype(1.0) / np_dtype(value))


def map_coords(x, y, cfg: Config):
    """The row and column coordinates, in cells, of world coordinates: the
    cell is their floor (Map.py:26-44: H/2 - y/cell, W/2 + x/cell)."""
    cell = cfg.map_grid_cell_size
    inv = reciprocal(cell, x.dtype)
    return (cfg.map_y_width / 2.0) / cell - y * inv, (cfg.map_x_width / 2.0) / cell + x * inv


def world_to_map(x, y, cfg: Config):
    """The cell ``(i, j)`` of world coordinates and whether it lies on the
    map."""
    H, W = cfg.map_shape
    u, v = map_coords(x, y, cfg)
    i = torch.floor(u).to(torch.int32)
    j = torch.floor(v).to(torch.int32)
    return i, j, (i >= 0) & (j >= 0) & (i < H) & (j < W)


def radius_cells_sq(radius, cfg: Config):
    r = radius * reciprocal(cfg.map_grid_cell_size, radius.dtype)
    return r * r


def in_disc(i, j, gi, gj, rsq):
    """Cell ``(i, j)`` lies in the disc of squared radius ``rsq`` (in cells)
    about cell ``(gi, gj)`` (Map.py:52-64: the integer square sum against
    the float squared radius)."""
    di, dj = i - gi, j - gj
    return (dj * dj + di * di).to(rsq.dtype) < rsq


def wall_hits(s: dict, cfg: Config):
    """``[E, A]``: a static occupied cell lies in the disc of a valid agent
    whose centre is on the map (collision_avoidance_env.py:494-506)."""
    gi, gj, on_map = world_to_map(s["pos"][..., 0], s["pos"][..., 1], cfg)
    rsq = radius_cells_sq(s["radius"], cfg)
    cells = cfg.static_cells(gi.device)
    hit = in_disc(cells[:, 0], cells[:, 1], gi[..., None], gj[..., None], rsq[..., None])
    return hit.any(dim=-1) & on_map & s["valid"]


def agent_map(s: dict, cfg: Config):
    """``[E, H, W]`` bool: the static map with the discs of the valid agents
    whose centre is on the map stamped in (Map.add_agents_to_map,
    Map.py:46-64)."""
    pos = s["pos"]
    E, A = pos.shape[:2]
    H, W = cfg.map_shape
    dev = pos.device
    grid = torch.zeros((E, H, W), dtype=torch.bool, device=dev)
    cells = cfg.static_cells(dev)
    grid[:, cells[:, 0], cells[:, 1]] = True
    gi, gj, on_map = world_to_map(pos[..., 0], pos[..., 1], cfg)
    rsq = radius_cells_sq(s["radius"], cfg)
    gi, gj, rsq, on = (x[:, :, None, None] for x in (gi, gj, rsq, on_map & s["valid"]))
    rows = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    for a in range(A):
        grid |= in_disc(rows, cols, gi[:, a], gj[:, a], rsq[:, a]) & on[:, a]
    return grid


def laserscan(s: dict, cfg: Config):
    """``[E, A, L]`` ranges of every agent's scan (LaserScanSensor.py:49-101):
    the beams at ``linspace(-pi/2, pi/2, L)`` about the heading march the
    agent-stamped map in range samples ``k * 0.1``; a sample hits on an
    occupied cell of the map that is not in the agent's own disc.  With k1,
    k2 the first two hits, the range is sample ``k2 - 1`` (the last at which
    exactly one hit was counted), sample R - 1 with one hit, and the
    maximum range with none.  In blocks of envs."""
    pos = s["pos"]
    E = pos.shape[0]
    H, W = cfg.map_shape
    block = max(1, MAP_BLOCK_CELLS // (H * W))
    return torch.cat([_scan_block({k: s[k][e:e + block] for k in ("pos", "radius", "valid",
                                                                  "heading")}, cfg)
                      for e in range(0, E, block)])


def _beams(s: dict, cfg: Config):
    """``(samples [R], cos [E, A, L], sin [E, A, L])``: the range samples and
    the directions of every agent's beams."""
    dt_, dev = s["pos"].dtype, s["pos"].device
    samples = torch.arange(LASER_SAMPLES, device=dev).to(dt_) * LASER_RESOLUTION
    table = torch.tensor(np.linspace(-math.pi / 2, math.pi / 2, cfg.laserscan_length),
                         device=dev).to(dt_)
    angle = table + s["heading"][..., None]
    return samples, torch.cos(angle), torch.sin(angle)


def _scan_block(s: dict, cfg: Config):
    pos = s["pos"]
    E = pos.shape[0]
    H, W = cfg.map_shape
    dev = pos.device
    flat = agent_map(s, cfg).reshape(E, H * W)
    samples, cos, sin = _beams(s, cfg)
    gi, gj, on_map = world_to_map(pos[..., 0], pos[..., 1], cfg)
    rsq = radius_cells_sq(s["radius"], cfg)
    count = torch.zeros(cos.shape, dtype=torch.int32, device=dev)
    last = torch.full(cos.shape, -1, dtype=torch.long, device=dev)
    for k in range(LASER_SAMPLES):
        i, j, inside = world_to_map(pos[..., 0, None] + samples[k] * cos,
                                    pos[..., 1, None] + samples[k] * sin, cfg)
        i, j = i.clamp(0, H - 1), j.clamp(0, W - 1)
        occupied = torch.gather(flat, 1, (i * W + j).reshape(E, -1).long()).reshape(i.shape)
        own = in_disc(i, j, gi[..., None], gj[..., None], rsq[..., None]) & on_map[..., None]
        count = count + (occupied & ~own & inside).to(torch.int32)
        last = torch.where(count == 1, k, last)
    return torch.where(last >= 0, samples[last.clamp(min=0)],
                       torch.full_like(cos, LASER_MAX_RANGE))


# ---------------------------------------------------------------- margins

# the eight neighbours of a cell, (row, column) offsets: bit b of a margin
# code says whether neighbour b's hit differs from the cell's; bit 8 is the
# cell's own hit
NEIGHBOURS = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1) if di or dj)
HIT_BIT = len(NEIGHBOURS)
# the fields that step_margins reads of the states before and after a step
MARGIN_FIELDS = ("pos", "goal", "heading", "delta_heading", "heading_ego_frame", "turning_dir",
                 "radius", "valid", "is_at_goal", "ran_out_of_time", "in_collision",
                 "was_in_collision_already", "is_done")
# _turning_dir's test of a turning direction near zero, and the decay that
# clamps a turning direction under 0.1 to exactly zero
TURN_NEAR_ZERO = 1e-5
TURN_KINK = 0.1


def _edge_distance(u):
    """The distance, in cells, of cell coordinates ``u`` to their cell's
    nearer edge, from the coordinate as the step floors it."""
    f = u.double() - torch.floor(u).double()
    return torch.minimum(f, 1.0 - f)


def scan_margins(s: dict, cfg: Config):
    """``[E, A]`` metres: for every valid agent, the smallest distance by
    which a sample of its scan missed a neighbouring cell whose hit (occupied
    on the agent-stamped map, outside the agent's own disc, on the map)
    differs from that of the sample's cell, over each beam's samples up to
    its second hit; a distance through a corner is the Euclidean one.  No
    such sample: infinite.  In blocks of envs."""
    E, A = s["pos"].shape[:2]
    H, W = cfg.map_shape
    block = max(1, MAP_BLOCK_CELLS // (A * H * W))
    out = torch.cat([_scan_margin_block({k: s[k][e:e + block] for k in ("pos", "radius", "valid",
                                                                       "heading")}, cfg)
                     for e in range(0, E, block)])
    return torch.where(s["valid"], out * cfg.map_grid_cell_size, torch.full_like(out, math.inf))


def _scan_margin_block(s: dict, cfg: Config):
    pos = s["pos"]
    E, A = pos.shape[:2]
    H, W = cfg.map_shape
    dev = pos.device
    grid = agent_map(s, cfg)
    gi, gj, on_map = world_to_map(pos[..., 0], pos[..., 1], cfg)
    rsq = radius_cells_sq(s["radius"], cfg)
    rows = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    # each agent's hits, with two rings of cells off the map around them
    hit = torch.zeros((E, A, H + 4, W + 4), dtype=torch.bool, device=dev)
    for a in range(A):
        own = in_disc(rows, cols, gi[:, a, None, None], gj[:, a, None, None],
                      rsq[:, a, None, None]) & on_map[:, a, None, None]
        hit[:, a, 2:-2, 2:-2] = grid & ~own
    # codes of the map's cells and the first ring around them
    centre = hit[:, :, 1:-1, 1:-1]
    code = centre.to(torch.int16) << HIT_BIT
    for b, (di, dj) in enumerate(NEIGHBOURS):
        near = hit[:, :, 1 + di:H + 3 + di, 1 + dj:W + 3 + dj]
        code |= (near != centre).to(torch.int16) << b
    del hit, centre
    flat = code.reshape(E, -1)
    agent_base = (torch.arange(A, device=dev) * (H + 2) * (W + 2))[None, :, None]

    samples, cos, sin = _beams(s, cfg)
    count = torch.zeros(cos.shape, dtype=torch.int32, device=dev)
    margin = torch.full(cos.shape, math.inf, dtype=torch.float64, device=dev)
    for k in range(LASER_SAMPLES):
        u, v = map_coords(pos[..., 0, None] + samples[k] * cos,
                          pos[..., 1, None] + samples[k] * sin, cfg)
        fu, fv = torch.floor(u), torch.floor(v)
        i, j = fu.to(torch.int64), fv.to(torch.int64)
        coded = (i >= -1) & (i <= H) & (j >= -1) & (j <= W)
        idx = agent_base + (i + 1).clamp(0, H + 1) * (W + 2) + (j + 1).clamp(0, W + 1)
        c = torch.gather(flat, 1, idx.reshape(E, -1)).reshape(i.shape)
        c = torch.where(coded, c, torch.zeros_like(c))
        du, dv = u.double() - fu.double(), v.double() - fv.double()
        along = {-1: (du, dv), 1: (1.0 - du, 1.0 - dv)}
        m = torch.full_like(margin, math.inf)
        for b, (di, dj) in enumerate(NEIGHBOURS):
            d2 = sum(along[o][axis] ** 2 for axis, o in enumerate((di, dj)) if o)
            m = torch.where(((c >> b) & 1).bool(), torch.minimum(m, torch.sqrt(d2)), m)
        margin = torch.where(count < 2, torch.minimum(margin, m), margin)
        count = count + ((c >> HIT_BIT) & 1).to(torch.int32)
    return margin.amin(dim=-1)


def step_margins(before: dict, after: dict, cfg: Config):
    """``[E]``: each env's smallest distance, over its valid agents, by which
    a comparison of the step from ``before`` to ``after`` that sets a flag,
    a state's branch or a scan's range missed its threshold; each a distance
    in metres, or in radians for a heading (a metre and a radian count
    alike: at 1-8 m and about pi their float32 rounding is of one size).

    Over the agents that the step moved (valid, not done before it):
    ``dist_to_goal`` against ``near_goal_threshold`` (``is_at_goal``) and
    against 1e-8 (the goal direction's test); the heading, its ego-frame
    angle and its change against +-pi (``wrap``); the heading against 0 (the
    sign that ``_turning_dir`` takes of the command).  Over the agents that
    the next step moves (valid, not done after it): ``|turning_dir|``
    against 1e-5 (``_turning_dir``'s near-zero test), except that a turning
    direction of exactly zero comes from the decay's clamp, flat there, and
    reaches the test only where its value before the step moves past 0.1 +
    1e-5: that is its distance.  Over pairs of valid agents whose first can
    still collide (not at the goal, no collision before): the distance
    against the summed radii (``in_collision``).  Over every valid agent (stamped and sensed, done or not): its centre against
    the edges of its own cell (its stamped disc, its own-disc test, its
    place on the map and the wall test), and where the laser senses, its
    scan's samples (:func:`scan_margins`).  Left out, since no rounding of a
    position or heading turns them: ``time_remaining <= 0``, the step
    counters, and the dones and the reset pick, which follow the flags
    above; and the getting-close reward (``nearest`` against
    ``getting_close_range``), which moves a read but no state.  The
    other-agents sensor's rounding and sort are not modelled: a world that
    senses them raises."""
    if "other_agents_states" in cfg.sensors:
        raise ValueError("step margins model a world without the other-agents sensor")
    f64 = torch.float64
    valid = after["valid"]
    moved = valid & ~(before["is_at_goal"] | before["ran_out_of_time"] | before["in_collision"])
    inf = torch.full(valid.shape, math.inf, dtype=f64, device=valid.device)

    def over(mask, m):
        return torch.where(mask, m.to(f64), inf)

    pos = after["pos"].double()
    gd = pos - after["goal"].double()
    dist = torch.sqrt(gd[..., 0] ** 2 + gd[..., 1] ** 2)
    heading = after["heading"].double()
    turn = after["turning_dir"].double()
    u, v = map_coords(after["pos"][..., 0], after["pos"][..., 1], cfg)
    parts = [
        over(moved, (dist - cfg.near_goal_threshold).abs()),
        over(moved, (dist - 1e-8).abs()),
        over(moved, math.pi - heading.abs()),
        over(moved, math.pi - after["heading_ego_frame"].double().abs()),
        over(moved, math.pi - after["delta_heading"].double().abs()),
        over(moved, heading.abs()),
        over(valid & ~after["is_done"],
             torch.where(turn == 0.0, TURN_KINK + TURN_NEAR_ZERO
                         - before["turning_dir"].double().abs(), turn.abs() - TURN_NEAR_ZERO)
             .abs()),
        over(valid, torch.minimum(_edge_distance(u), _edge_distance(v))
             * cfg.map_grid_cell_size),
    ]
    A = valid.shape[-1]
    rel = pos[:, None, :, :] - pos[:, :, None, :]
    gap = (torch.sqrt(rel[..., 0] ** 2 + rel[..., 1] ** 2)
           - (after["radius"][:, :, None] + after["radius"][:, None, :]).double()).abs()
    can_hit = valid & ~after["is_at_goal"] & ~after["was_in_collision_already"]
    pair = (can_hit[:, :, None] & valid[:, None, :]
            & ~torch.eye(A, dtype=torch.bool, device=valid.device))
    parts.append(torch.where(pair, gap, torch.full_like(gap, math.inf)).amin(dim=-1))
    if "laserscan" in cfg.sensors:
        parts.append(scan_margins(after, cfg))
    return torch.stack(parts).amin(dim=0).amin(dim=-1)


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
    """The sensor pass and the observation (collision_avoidance_env.py:555-575).
    The laser's scans enter a history of the last ``laserscan_num_past``,
    newest first, which the first scan fills (LaserScanSensor.py:84-88)."""
    s = dict(s)
    dt_ = s["pos"].dtype
    obs = {}
    if "laserscan" in cfg.sensors:
        ranges = laserscan(s, cfg)[:, :, None, :]
        hist = s["laserscan_history"]
        rolled = torch.cat([ranges, hist[:, :, :-1, :]], dim=2)
        first = (s["laserscan_count"] == 0)[..., None, None]
        s["laserscan_history"] = torch.where(first, ranges.expand_as(rolled), rolled)
        s["laserscan_count"] = s["laserscan_count"] + 1
        obs["laserscan"] = s["laserscan_history"]
    if "other_agents_states" in cfg.sensors:
        rows, closest, counts = other_agents(s, cfg)
        s.update(other_agent_states=closest, sensed_others=rows,
                 num_other_agents_observed=counts)
    obs.update({"is_learning": is_learning(s).to(dt_)[..., None],
                "num_other_agents": s["num_other_agents_observed"].to(dt_)[..., None],
                "dist_to_goal": s["dist_to_goal"][..., None],
                "heading_ego_frame": s["heading_ego_frame"][..., None],
                "pref_speed": s["pref_speed"][..., None], "radius": s["radius"][..., None],
                "other_agents_states": s["sensed_others"]})
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
