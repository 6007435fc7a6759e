"""PPO trainer for the LearningPolicy path, on the device (port of
:mod:`gym_collision_avoidance_tpu.train.ppo`).

One iteration is a rollout of ``horizon`` auto-reset steps (``env.autoreset``)
under ``torch.no_grad()``, GAE(lambda) over it with ``(1 - done)`` masking at
the auto-reset boundaries, and ``epochs`` passes over ``num_minibatches``
minibatches of whole env-major sample streams, each a clipped-surrogate PPO
loss (Schulman et al. 2017), its gradients by autograd and one step of
:mod:`train.optim` (optax's clip-by-global-norm and Adam).  Gradients never
reach the env: visited states are data, as the JAX trainer's
``stop_gradient`` makes them.

Three policy families (``PPOConfig.policy_arch``), as in the JAX package:

* ``mlp``: :class:`ActorCritic`, a Gaussian over the LearningPolicy's
  ``[0, 1]^2`` box, in the JAX package's names and ``[in, out]`` layout;
* ``ga3c``: the GA3C-CADRL LSTM net in its training form
  (``models.ga3c_cadrl.GA3CCADRL(trainable=True)``), a categorical over its 11
  actions;
* ``drl_long``: the DRL-Long CNN actor-critic (``models.drl_long``) on the
  3-deep scan stack, through the Gaussian family.

The randomness is explicit.  :meth:`PPOTrainer.sample_noise` draws from a
``torch.Generator`` what the JAX trainer draws from its keys: the Gaussian
families' ``eps [T, B, 2]``, GA3C's Gumbel noise ``[T, B, 11]`` (the sample is
``argmax(logits + g)``, what ``jax.random.categorical`` computes), and one
permutation of the ``B`` sample streams per epoch.  ``train_step`` takes
either a generator or those tensors, so a test can hand both trainers the
same draws.  Initial weights come from a CPU generator seeded with an int,
so a seed gives the same weights on every device.

Usage::

    train_step, init_fn, obs_dim = make_ppo(PPOConfig(policy_arch="ga3c"))
    carry = init_fn(0)
    gen = torch.Generator("cuda").manual_seed(7)
    *carry, metrics = train_step(*carry, rng=gen)

:func:`make_sharded_ppo` runs the same iteration data-parallel over an
``("env",)`` mesh of ranks (``parallel/mesh.py``), as the JAX package's
``shard_map`` does: each rank rolls out its slice of the envs, and the
advantage statistics, the gradients and the metrics are averaged over the
ranks (``all_reduce``) where the JAX trainer ``pmean``-s them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gym_collision_avoidance_torch.config import EnvConfig
from gym_collision_avoidance_torch.core import maths, prng
from gym_collision_avoidance_torch.core.device import as_device_tensor, resolve_device
from gym_collision_avoidance_torch.env import autoreset
from gym_collision_avoidance_torch.env.step import env_reset
from gym_collision_avoidance_torch.maps.grid import reciprocal
from gym_collision_avoidance_torch.models import drl_long, ga3c_cadrl
from gym_collision_avoidance_torch.obs import spec as obs_spec
from gym_collision_avoidance_torch.parallel.distributed import replicate_global
from gym_collision_avoidance_torch.parallel.mesh import EnvMesh, pool_rows
from gym_collision_avoidance_torch.policies import registry as policies
from gym_collision_avoidance_torch.train import optim

# the items of the carry ``(params, opt_state, states, counters, obs)`` that
# hold env rows (a rank's own under a mesh); params and opt_state are replicated
CARRY_ENV_ROWS = (2, 3, 4)
_HALF_LOG_2PI = 0.5 * float(np.log(2.0 * np.pi))
_HALF_LOG_2PI_E = 0.5 * float(np.log(2.0 * np.pi * np.e))


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters, as the JAX package's ``PPOConfig``."""

    num_envs: int = 256
    horizon: int = 64              # T steps per rollout
    num_agents: int = 2
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    epochs: int = 4
    num_minibatches: int = 4       # along the env axis
    lr: float = 3e-4
    value_coef: float = 0.5
    entropy_coef: float = 1e-3
    max_grad_norm: float = 0.5
    hidden: int = 256
    # dense progress shaping added to the env reward on the training side only
    shaping_coef: float = 0.3
    traffic_policy: int = policies.NONCOOP
    # "mlp", "ga3c" or "drl_long" (module docstring)
    policy_arch: str = "mlp"
    # False: agent 0 learns against traffic_policy agents.  True: every agent
    # runs and trains the shared net; frozen (done) agents carry zero weight.
    self_play: bool = False
    seed: int = 0

    @property
    def mb_envs(self) -> int:
        """Learner sample streams per minibatch (env x learner agent)."""
        num_streams = self.num_envs * (self.num_agents if self.self_play else 1)
        if num_streams % self.num_minibatches:
            raise ValueError(f"{num_streams} sample streams do not split into "
                             f"{self.num_minibatches} minibatches")
        return num_streams // self.num_minibatches


class ActorCritic(nn.Module):
    """The MLP actor-critic: ``W1 [D, H]``, ``b1``, ``W2 [H, H]``, ``b2``, the
    policy head ``Wp [H, 2]``, ``bp``, a state-independent ``log_std [2]`` and
    the value head ``Wv [H, 1]``, ``bv``, in the JAX package's names and
    layout, all trainable."""

    NAMES = ("W1", "b1", "W2", "b2", "Wp", "bp", "log_std", "Wv", "bv")

    def __init__(self, arrays: Mapping[str, np.ndarray], dtype=None):
        super().__init__()
        for name in self.NAMES:
            t = torch.as_tensor(np.array(arrays[name], copy=True))
            self.register_parameter(name, nn.Parameter(t if dtype is None else t.to(dtype)))

    def forward(self, x):
        return actor_critic(self, x)


def init_actor_critic(generator: torch.Generator, obs_dim: int, hidden: int = 256,
                      device=None) -> ActorCritic:
    """He-initialised trunk and heads scaled by 1e-2 (the JAX package's
    ``init_actor_critic``), drawn from ``generator`` (a CPU generator),
    ``log_std`` at -1.2.  ``device=None`` means CUDA."""
    device = resolve_device(device)
    s1, s2 = (2.0 / obs_dim) ** 0.5, (2.0 / hidden) ** 0.5

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, dtype=torch.float32) * scale).numpy()

    zeros = lambda n: np.zeros((n,), np.float32)  # noqa: E731
    arrays = {
        "W1": normal((obs_dim, hidden), s1), "b1": zeros(hidden),
        "W2": normal((hidden, hidden), s2), "b2": zeros(hidden),
        "Wp": normal((hidden, 2), s2 * 1e-2), "bp": zeros(2),
        "log_std": np.full((2,), -1.2, np.float32),
        "Wv": normal((hidden, 1), s2), "bv": zeros(1),
    }
    return ActorCritic(arrays).to(device)


def actor_critic(p: ActorCritic, x):
    """(mean in (0, 1)^2, log_std ``[2]``, value) for flattened ego obs
    ``x``, cast to the weights' dtype."""
    x = x.to(p.W1.dtype)
    h = torch.relu(torch.matmul(x, p.W1) + p.b1)
    h = torch.relu(torch.matmul(h, p.W2) + p.b2)
    mean = torch.sigmoid(torch.matmul(h, p.Wp) + p.bp)
    value = (torch.matmul(h, p.Wv) + p.bv)[..., 0]
    return mean, maths.clip(p.log_std, -4.0, 0.0), value


def _gauss_logp(act, mean, log_std):
    """Diagonal-Gaussian log density at the stored (clipped) action."""
    z = (act - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * z * z - log_std - _HALF_LOG_2PI, dim=-1)


def compute_gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """GAE(lambda) over a ``[T, E]`` rollout with auto-reset boundaries:
    ``dones[t]`` cuts the bootstrap of the transition at t.  A reverse loop
    over T with the JAX scan's arithmetic.  Returns (advantages ``[T, E]``,
    value targets)."""
    dones = dones.to(rewards.dtype)
    adv = torch.empty_like(rewards)
    gae, next_val = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_val * nonterm - values[t]
        gae = delta + gamma * lam * nonterm * gae
        adv[t] = gae
        next_val = values[t]
    return adv, adv + values


def trainable_params(params: nn.Module) -> Dict[str, nn.Parameter]:
    """The net's parameters under the JAX package's names, sorted as JAX
    orders a dict's leaves (the optimizer's order)."""
    if isinstance(params, drl_long.DRLLongNet):
        named = drl_long.jax_named_parameters(params)
    else:
        named = dict(params.named_parameters())
    return dict(sorted(named.items()))


# ------------------------------------------------------- policy families


class _Gaussian:
    """A diagonal Gaussian over the LearningPolicy box (mlp, drl_long)."""

    noise = "eps"

    def __init__(self, device):
        self.device = device

    def draw(self, generator, T, B):
        return torch.randn((T, B, 2), generator=generator, device=generator.device)

    def dist_sample(self, out, eps):
        mean, log_std = out
        return torch.clamp(mean + torch.exp(log_std) * eps, 0.0, 1.0)

    def dist_logp(self, out, act):
        mean, log_std = out
        return _gauss_logp(act, mean, log_std)

    def dist_entropy(self, out):
        # JAX sums log_std over every element it holds: [2] for the MLP, the
        # broadcast [n, 2] for DRL-Long, whose entropy is then n times the
        # per-sample one.  Kept for parity (ROADMAP §3).
        mean, log_std = out
        return torch.sum(log_std + _HALF_LOG_2PI_E).expand(mean.shape[:1])

    def to_ext(self, act):
        return act


class _MLP(_Gaussian):
    def __init__(self, device, obs_dim, hidden):
        super().__init__(device)
        self.obs_dim, self.hidden = obs_dim, hidden

    def net_init(self, generator):
        return init_actor_critic(generator, self.obs_dim, self.hidden, self.device)

    def net_apply(self, params, x):
        mean, log_std, value = actor_critic(params, x)
        return (mean, log_std), value


class _DRLLong(_Gaussian):
    def __init__(self, device, obs_dim, laserscan_length):
        super().__init__(device)
        if obs_dim != 4 + drl_long.FRAMES * laserscan_length:
            raise ValueError(f"drl_long obs width {obs_dim} is not 4 + 3 x {laserscan_length}")
        self.L = laserscan_length

    def net_init(self, generator):
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
        net = drl_long.init_actor_critic_params(self.L, seed=seed, device=self.device)
        return net.requires_grad_(True)

    def net_apply(self, params, x):
        # layout [d_goal, heading_ego, pref, r, scans]; the reference's scan
        # normalisation (DRLLongPolicy.py:81), / 6 as XLA compiles it
        scan = x[:, 4:].reshape(x.shape[0], drl_long.FRAMES, self.L)
        scan = scan * reciprocal(6.0, x.dtype) - 0.5
        mean, log_std, value = drl_long.forward_actor_critic(params, scan, x[:, 0:2], x[:, 2:4])
        return (mean, log_std), value


class _GA3C:
    """The GA3C-CADRL net and a categorical over its 11 actions."""

    noise = "gumbel"

    def __init__(self, device, obs_dim, num_agents):
        self.device = device
        self.K = (obs_dim - 5) // 7
        if 5 + 7 * self.K != obs_dim:
            raise ValueError(f"ga3c obs width {obs_dim} is not 5 + 7 K")
        self.A = num_agents

    def draw(self, generator, T, B):
        # jax.random.gumbel's "low" mode: -log(-log(u)), u uniform in [tiny, 1)
        u = torch.rand((T, B, ga3c_cadrl.NUM_ACTIONS), generator=generator,
                       device=generator.device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))

    def net_init(self, generator):
        return ga3c_cadrl.init_params(generator, self.K, device=self.device)

    def net_apply(self, params, x):
        others = x[:, 5:].reshape(x.shape[0], self.K, 7)
        logits, value = ga3c_cadrl.forward_parts_logits(params, x[:, :5], others,
                                                        max_seq_len=self.A - 1)
        return (logits,), value

    def dist_sample(self, out, gumbel):
        (logits,) = out
        return torch.argmax(gumbel + logits, dim=-1)[:, None].to(torch.float32)   # [B, 1]

    def dist_logp(self, out, act):
        (logits,) = out
        ls = torch.log_softmax(logits, dim=-1)
        # the masked one-hot sum of the JAX trainer, not a gather (whose
        # backward on CUDA is an atomic scatter-add, not deterministic)
        actions = torch.arange(ls.shape[-1], device=ls.device)
        onehot = (actions[None, :] == act[:, 0].to(torch.int32)[:, None]).to(ls.dtype)
        return torch.sum(onehot * ls, dim=-1)

    def dist_entropy(self, out):
        (logits,) = out
        ls = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(ls) * ls, dim=-1)

    def to_ext(self, act):
        return torch.cat([act, torch.zeros_like(act)], dim=-1)


# ------------------------------------------------------------- trainer


class PPOTrainer:
    """The pieces of one PPO iteration for ``ppo`` (``make_ppo`` returns
    its ``train_step``, ``init_fn`` and ``obs_dim``).

    Args:
        cfg: the env config; default float32, learning mode, a -0.01 time
            reward, and ``use_static_map`` for ``drl_long`` (the scan
            history).
        pool: ``[N, A, 6]`` scenario pool; default ``scenario_pool(64, A,
            seed=ppo.seed, side_length=3.0)``.
        static_cells: occupied-cell list of a laserscan config; default an
            empty one (an agents-only world).
        device: ``None`` means CUDA, or the mesh's device.
        mesh: an :class:`parallel.mesh.EnvMesh` (:func:`make_sharded_ppo`):
            ``ppo.num_envs`` is then this rank's count, the envs are the
            global batch's rows of this rank, and the advantage statistics,
            gradients and metrics are averaged over the ranks.  ``None``
            means a mesh of this process alone, whose averages leave every
            bit as it is.
    """

    def __init__(self, ppo: PPOConfig, cfg: Optional[EnvConfig] = None, pool=None,
                 sensors: Tuple[str, ...] = ("other_agents_states",),
                 states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
                 static_cells=None, device=None, mesh=None):
        self.device = device = resolve_device(mesh.device if device is None and mesh else device)
        self.mesh = mesh = EnvMesh(device) if mesh is None else mesh
        self.ppo = ppo
        E, A = ppo.num_envs, ppo.num_agents
        arch = ppo.policy_arch
        if arch not in ("mlp", "ga3c", "drl_long"):
            raise ValueError(f"unknown policy_arch {arch!r}")
        self.cfg = cfg = cfg or EnvConfig(dtype="float32", done_mode="learning",
                                          reward_time_step=-0.01,
                                          use_static_map=arch == "drl_long")
        if arch == "drl_long" and not cfg.use_static_map:
            raise ValueError("drl_long arch needs cfg.use_static_map=True (allocates the "
                             "laserscan history ring; pass static_cells=[] for an "
                             "agents-only world)")
        if pool is None:
            from gym_collision_avoidance_torch.scenarios import random_cases

            pool = random_cases.scenario_pool(64, A, seed=ppo.seed, side_length=3.0)
        self.pool = np.asarray(pool)
        learner_pid = policies.LEARNING_GA3C if arch == "ga3c" else policies.LEARNING
        if arch == "drl_long" and "laserscan" not in sensors:
            sensors = tuple(sensors) + ("laserscan",)
            states_in_obs = tuple(k for k in states_in_obs if k != "laserscan") + ("laserscan",)
        if static_cells is None and "laserscan" in sensors:
            static_cells = np.zeros((0, 2), np.int32)
        if static_cells is not None:
            static_cells = as_device_tensor(static_cells, torch.int32, device)
        self.sensors, self.states_in_obs, self.static_cells = sensors, states_in_obs, static_cells
        self.L = L = A if ppo.self_play else 1
        self.B = E * L
        # this rank's first global env and sample stream, and the global
        # stream count (the unsharded trainer's B)
        self.env_start = mesh.rank * E
        self.stream_start = self.env_start * L
        self.B_global = self.B * mesh.size
        if ppo.self_play:
            self.policy_id = np.full(A, learner_pid, np.int32)
            active = (int(learner_pid),)
        else:
            self.policy_id = np.array([learner_pid] + [ppo.traffic_policy] * (A - 1), np.int32)
            active = tuple(sorted({int(learner_pid), int(ppo.traffic_policy)}))
        if self.B % ppo.num_minibatches:
            raise ValueError(f"{self.B} sample streams do not split into "
                             f"{ppo.num_minibatches} minibatches")
        self.astep = autoreset.make_autoreset_step(
            cfg, self.pool, self.policy_id, active_policies=active, sensors=sensors,
            states_in_obs=states_in_obs, static_cells=static_cells, device=device)

        # the flattened ego obs width, from one probe reset
        probe = autoreset.state_from_case(cfg, self.pool[:1], self.policy_id, device=device)
        _, probe_obs = env_reset(probe, cfg, sensors, states_in_obs, None, static_cells)
        if arch == "ga3c":
            # the GA3C net's policy-obs layout (GA3CCADRLPolicy.py:68-74)
            self.ego_keys = tuple(k for k in states_in_obs
                                  if k not in obs_spec.DEFAULT_STATES_NOT_USED_IN_POLICY)
        elif arch == "drl_long":
            # [polar local goal, kinematic scalars, scan stack], scan last
            self.ego_keys = ("dist_to_goal", "heading_ego_frame", "pref_speed", "radius",
                             "laserscan")
            missing = [k for k in self.ego_keys if k not in tuple(states_in_obs)]
            if missing:
                raise ValueError(f"drl_long arch needs obs keys {missing}")
        else:
            self.ego_keys = tuple(states_in_obs)
        self.obs_dim = int(sum(math.prod(probe_obs[k].shape[2:]) for k in self.ego_keys))

        if arch == "ga3c":
            self.family = _GA3C(device, self.obs_dim, A)
        elif arch == "drl_long":
            self.family = _DRLLong(device, self.obs_dim, cfg.laserscan_length)
        else:
            self.family = _MLP(device, self.obs_dim, ppo.hidden)

    # -- pieces ---------------------------------------------------------

    def flatten_ego(self, obs) -> torch.Tensor:
        """Batched obs dict -> ``[B, obs_dim]`` float32 learner rows (agents
        0..L-1 of every env, env-major)."""
        return torch.cat([obs[k][:, :self.L].reshape(self.B, -1).to(torch.float32)
                          for k in self.ego_keys], dim=-1)

    def reset_batch(self):
        """Fresh states and first obs of every env: global env e on pool
        case ``e % N``, every env's PRNG key ``PRNGKey(seed + 1)``."""
        cases = pool_rows(self.pool, self.env_start, self.ppo.num_envs)
        st = autoreset.state_from_case(self.cfg, cases, self.policy_id,
                                       rng=prng.key(self.ppo.seed + 1), device=self.device)
        return env_reset(st, self.cfg, self.sensors, self.states_in_obs, None, self.static_cells)

    def init_fn(self, seed: int):
        """``(params, opt_state, states, counters, obs)``: a fresh net drawn
        from a CPU generator seeded with ``seed`` (with a mesh, rank 0's,
        broadcast), a fresh optimizer, and every env at the start of its
        pool case, its counter at its global index."""
        params = replicate_global(self.family.net_init(torch.Generator().manual_seed(seed)),
                                  self.mesh)
        states, obs = self.reset_batch()
        counters = torch.arange(self.env_start, self.env_start + self.ppo.num_envs,
                                dtype=torch.int32, device=self.device)
        return params, optim.init(trainable_params(params)), states, counters, obs

    def sample_noise(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One iteration's draws from ``generator`` (on its device), moved to
        the trainer's: ``eps`` or ``gumbel`` ``[T, B_global, k]``, a row per
        global sample stream, and ``perm [epochs, B]``.

        Every rank makes the unsharded trainer's draws, in its order (the
        permutations of the ``B_global`` streams, then the noise), so a
        stream's noise does not depend on the rank count; a rank reads its
        rows in :meth:`rollout`.  As under the JAX package's ``shard_map``,
        every rank shuffles its local streams by one permutation: the order
        of ``0 .. B - 1`` within the global one (itself uniform, and the
        global permutation when there is one rank).
        """
        T, B = self.ppo.horizon, self.B
        perm = torch.stack([torch.randperm(self.B_global, generator=generator,
                                           device=generator.device)
                            for _ in range(self.ppo.epochs)])
        noise = {self.family.noise: self.family.draw(generator, T, self.B_global),
                 "perm": torch.stack([p[p < B] for p in perm])}
        return {k: v.to(self.device) for k, v in noise.items()}

    @torch.no_grad()
    def rollout_step(self, params, states, counters, obs, noise_t):
        """One auto-reset step of the rollout with the step's noise
        ``noise_t`` (``[B, k]``): the next ``(states, counters, obs)`` and
        the step's sample (``x``, ``act``, ``logp``, ``value``, shaped
        ``reward``, ``done``, ``alive``, ``raw_reward``, ``game_over``)."""
        ppo, fam = self.ppo, self.family
        E, A, L, B = ppo.num_envs, ppo.num_agents, self.L, self.B
        dtype, f32 = states.pos.dtype, torch.float32
        x = self.flatten_ego(obs)
        # learners already done (frozen by the env) carry zero loss weight
        alive = (~states.is_done[:, :L]).reshape(B).to(f32)
        out, value = fam.net_apply(params, x)
        act = fam.dist_sample(out, noise_t)
        logp = fam.dist_logp(out, act)
        d_prev = states.dist_to_goal[:, :L].to(f32)
        ext = torch.cat([fam.to_ext(act).to(dtype).reshape(E, L, 2),
                         torch.zeros((E, A - L, 2), dtype=dtype, device=self.device)], dim=1)
        states, counters, obs, rew, game_over = self.astep(states, counters, ext)
        go_f = game_over.to(f32)[:, None]
        raw = rew[:, :L].to(f32)
        shaped = raw + ppo.shaping_coef * (
            d_prev - states.dist_to_goal[:, :L].to(f32)) * (1.0 - go_f)
        # the env reset, or this learner's episode latched done: the value
        # bootstrap is cut either way
        done = (game_over[:, None] | states.is_done[:, :L]).reshape(B)
        sample = {"x": x, "act": act, "logp": logp, "value": value,
                  "reward": shaped.reshape(B), "done": done, "alive": alive,
                  "raw_reward": raw.reshape(B), "game_over": game_over}
        return states, counters, obs, sample

    @torch.no_grad()
    def rollout(self, params, states, counters, obs, noise):
        """T auto-reset steps, without gradients, each with this rank's rows
        of the step's ``[B_global, k]`` noise; returns the carried ``(states,
        counters, obs)`` and the ``[T, ...]`` stacked samples with the
        bootstrap ``last_value``."""
        rows = slice(self.stream_start, self.stream_start + self.B)
        samples = []
        for t in range(self.ppo.horizon):
            states, counters, obs, sample = self.rollout_step(
                params, states, counters, obs, noise[self.family.noise][t, rows])
            samples.append(sample)
        data = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
        _, data["last_value"] = self.family.net_apply(params, self.flatten_ego(obs))
        return states, counters, obs, data

    def loss_fn(self, params, batch):
        """Clipped-surrogate PPO loss over one minibatch of ``[n]`` samples;
        ``alive`` weights mask frozen learner samples.  Returns ``(loss,
        (value_loss, clip_frac))``."""
        ppo, fam = self.ppo, self.family
        out, value = fam.net_apply(params, batch["x"])
        logp = fam.dist_logp(out, batch["act"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        pg = -torch.minimum(ratio * adv,
                            maths.clip(ratio, 1.0 - ppo.clip_eps, 1.0 + ppo.clip_eps) * adv)
        w = batch["alive"]
        wsum = torch.clamp_min(torch.sum(w), 1.0)
        v_err = value - batch["target"]
        v_loss = 0.5 * torch.sum(v_err * v_err * w) / wsum
        ent = torch.sum(fam.dist_entropy(out) * w) / wsum
        loss = torch.sum(pg * w) / wsum + ppo.value_coef * v_loss - ppo.entropy_coef * ent
        clipped = (torch.abs(ratio - 1.0) > ppo.clip_eps).to(w.dtype)
        frac_clipped = torch.sum(clipped * w) / wsum
        return loss, (v_loss, frac_clipped)

    def gradients(self, params, mb):
        """Normalise ``mb``'s advantages (alive-weighted, by the statistics
        over every rank: ``[sum w, sum a w]`` and then ``sum w d^2`` averaged
        over the ranks, as the JAX trainer ``pmean``-s them), then the loss's
        gradients by name (:func:`trainable_params`) and the ``(loss,
        value_loss, clip_frac)`` stats."""
        a, w = mb["adv"], mb["alive"]
        s = self.mesh.pmean(torch.stack([torch.sum(w), torch.sum(a * w)]))
        wsum = torch.clamp_min(s[0], 1.0)
        mu = s[1] / wsum
        d = a - mu
        var = self.mesh.pmean(torch.sum(w * (d * d))) / wsum
        mb = dict(mb, adv=d * torch.reciprocal(maths.sqrt_rn(var + 1e-8)))
        named = trainable_params(params)
        loss, (v_loss, frac) = self.loss_fn(params, mb)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        return grads, torch.stack([loss.detach(), v_loss.detach(), frac.detach()])

    def minibatches(self, data, adv, target, perm):
        """The update's minibatches in order: for each epoch, the sample
        streams shuffled by ``perm[epoch]`` and cut into ``num_minibatches``
        runs of whole env-major streams."""
        ppo, T, B = self.ppo, self.ppo.horizon, self.B
        n_mb = ppo.num_minibatches
        em = {"x": data["x"], "act": data["act"], "logp": data["logp"], "adv": adv,
              "target": target, "alive": data["alive"]}
        em = {k: v.transpose(0, 1) for k, v in em.items()}                  # [B, T, ...]
        for e in range(ppo.epochs):
            mbs = {k: v[perm[e]].reshape((n_mb, (B // n_mb) * T) + v.shape[2:])
                   for k, v in em.items()}
            for m in range(n_mb):
                yield {k: v[m] for k, v in mbs.items()}

    def minibatch_step(self, params, opt_state, mb):
        """One gradient step on minibatch ``mb``: :meth:`gradients`
        (averaged over the ranks in one flattened ``all_reduce``, so the
        global-norm clip sees the averaged gradient), then the clip-and-Adam
        chain (``optim.update``), whose updates are added to ``params`` in
        place.  Returns ``(grads, stats, updates, next opt_state)``."""
        grads, stats = self.gradients(params, mb)
        grads = self.mesh.pmean_flat(grads)
        updates, opt_state = optim.update(grads, opt_state, self.ppo.max_grad_norm, self.ppo.lr)
        optim.apply_updates(trainable_params(params), updates)
        return grads, stats, updates, opt_state

    def update(self, params, opt_state, data, adv, target, perm):
        """``epochs`` passes over the minibatches (:meth:`minibatches`), one
        :meth:`minibatch_step` each; updates ``params`` in place and returns
        the next optimizer state and the ``[epochs, n_mb, 3]`` stats."""
        ppo = self.ppo
        stats = []
        for mb in self.minibatches(data, adv, target, perm):
            _, s, _, opt_state = self.minibatch_step(params, opt_state, mb)
            stats.append(s)
        return opt_state, torch.stack(stats).reshape(ppo.epochs, ppo.num_minibatches, 3)

    def train_step(self, params, opt_state, states, counters, obs, rng=None, noise=None,
                   timings=None):
        """One iteration: rollout, GAE and the update epochs.

        Args:
            rng: a ``torch.Generator`` to draw the iteration's noise from
                (:meth:`sample_noise`), unless ``noise`` gives it.
            noise: ``{"eps" or "gumbel": [T, B_global, k], "perm": [epochs,
                B]}`` (one rank: ``B_global`` is ``B``).
            timings: a dict to which each phase (``rollout``, ``gae``,
                ``update``) adds its seconds; the device is synchronised at
                every boundary and each phase is a ``torch.profiler`` range
                (``ppo_rollout``, ...).  ``None`` adds no synchronisation.

        Returns:
            ``(params, opt_state, states, counters, obs, metrics)``; the net
            is updated in place and returned.  With a mesh, the four reward
            and episode metrics are means over the ranks (JAX's ``pmean``:
            ``episodes_finished`` is then the mean of the ranks' counts), and
            ``loss``, ``value_loss`` and ``clip_frac`` are this rank's.
        """
        if noise is None:
            if rng is None:
                raise ValueError("train_step needs rng (a torch.Generator) or noise")
            noise = self.sample_noise(rng)
        ppo = self.ppo
        with self._phase("rollout", timings):
            states, counters, obs, data = self.rollout(params, states, counters, obs, noise)
        with self._phase("gae", timings):
            adv, target = compute_gae(data["reward"], data["value"], data["done"],
                                      data["last_value"], ppo.gamma, ppo.gae_lambda)
        with self._phase("update", timings):
            opt_state, stats = self.update(params, opt_state, data, adv, target, noise["perm"])
        go_f = data["game_over"].to(torch.float32)
        live_raw = data["raw_reward"] * data["alive"]
        step_reward, shaped_reward, episodes, live_sum = self.mesh.pmean(torch.stack([
            torch.mean(live_raw), torch.mean(data["reward"] * data["alive"]), torch.sum(go_f),
            torch.sum(live_raw)]))
        metrics = {
            "loss": torch.mean(stats[..., 0]),
            "value_loss": torch.mean(stats[..., 1]),
            "clip_frac": torch.mean(stats[..., 2]),
            "mean_step_reward": step_reward,
            "mean_shaped_reward": shaped_reward,
            "episodes_finished": episodes,
            # mean raw return per (learner, episode) among the episodes that
            # finished in this rollout (every env reset ends L of them)
            "mean_return_per_episode": live_sum / torch.clamp_min(episodes * self.L, 1.0),
        }
        return params, opt_state, states, counters, obs, metrics

    @contextlib.contextmanager
    def _phase(self, name, timings):
        if timings is None:
            yield
            return
        with torch.profiler.record_function(f"ppo_{name}"):
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def make_ppo(ppo: PPOConfig, cfg: Optional[EnvConfig] = None, pool=None,
             sensors: Tuple[str, ...] = ("other_agents_states",),
             states_in_obs: Tuple[str, ...] = obs_spec.DEFAULT_STATES_IN_OBS,
             static_cells=None, device=None):
    """Build the PPO iteration: ``(train_step, init_fn, obs_dim)``.

    * ``init_fn(seed) -> (params, opt_state, states, counters, obs)``;
    * ``train_step(params, opt_state, states, counters, obs, rng=None,
      noise=None, timings=None) -> (params, opt_state, states, counters,
      obs, metrics)`` (:meth:`PPOTrainer.train_step`).

    Env states and the pending obs carry over between iterations, so every
    step of every iteration advances a live episode.  ``device=None`` means
    CUDA.
    """
    trainer = PPOTrainer(ppo, cfg, pool, sensors, states_in_obs, static_cells, device)
    return trainer.train_step, trainer.init_fn, trainer.obs_dim


def make_sharded_ppo(ppo: PPOConfig, mesh, cfg: Optional[EnvConfig] = None, pool=None,
                     **kwargs):
    """Data-parallel PPO over ``mesh`` (a :class:`parallel.mesh.EnvMesh`),
    with :func:`make_ppo`'s signatures.

    ``ppo.num_envs`` is the global env count, split evenly over the ranks;
    each rank runs a :class:`PPOTrainer` on its ``num_envs / D`` envs on the
    mesh's device.  ``init_fn(seed)`` returns this rank's carry: the params
    (rank 0's, broadcast) and its rows of the global batch; ``train_step``
    draws the global noise and reads its rows, so the trajectories are the
    unsharded ones, and averages the advantage statistics and the gradients
    over the ranks once a minibatch, and the metrics once an iteration.  With
    more than one minibatch the shuffle is shard-local, as in the JAX
    package, so the minibatches differ from an unsharded run's by design.
    ``kwargs`` go to :class:`PPOTrainer` (``sensors``, ``states_in_obs``,
    ``static_cells``).
    """
    if ppo.num_envs % mesh.size:
        raise ValueError(f"num_envs {ppo.num_envs} not divisible by the {mesh.size}-rank mesh")
    local = dataclasses.replace(ppo, num_envs=ppo.num_envs // mesh.size)
    trainer = PPOTrainer(local, cfg, pool, mesh=mesh, **kwargs)
    return trainer.train_step, trainer.init_fn, trainer.obs_dim
