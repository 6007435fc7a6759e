"""The port's DRL-Long (CNN and policy kernel) against the JAX package on the
CPU: the seeded inits, the shipped checkpoint's forward and actor-critic,
a PyTorch ``CNNPolicy`` state dict through ``convert_torch_state_dict``, the
kernel on seeded laserscan states, and ``[DRL_LONG, RVO]`` laser rollouts
through ``env_step`` and ``AutoresetServer``.

Tolerances: seeded inits bitwise equal; float64 nets within atol 1e-12 of
JAX; float32 nets within rtol 1e-5 / atol 1e-6 (XLA's and oneDNN's
convolutions and products sum in other orders); the port's own
``CNNPolicy`` conversion bitwise equal to the module it came from; kernel
actions within atol 1e-6 for float32 weights and 1e-12 for float64; laser
rollouts in float64 with float64 weights: discrete outputs equal, floats
within atol 1e-9.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import convert
from gym_collision_avoidance_torch import env_step as t_env_step
from gym_collision_avoidance_torch.harness.serving import AutoresetServer as TServer
from gym_collision_avoidance_torch.models import drl_long as tnet
from gym_collision_avoidance_torch.policies import drl_long as tpol
from gym_collision_avoidance_torch.scenarios import random_cases as trc
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu import env_step as j_env_step
from gym_collision_avoidance_tpu.env import autoreset as jauto
from gym_collision_avoidance_tpu.harness.serving import AutoresetServer as JServer
from gym_collision_avoidance_tpu.maps import grid as jgrid
from gym_collision_avoidance_tpu.models import drl_long as jnet
from gym_collision_avoidance_tpu.policies import drl_long as jpol

DRL_LONG, RVO = 9, 8
CKPT = os.path.join(os.path.dirname(jnet.__file__), "weights", "drl_long_2agent_rvo_tpu.npz")
F32 = dict(rtol=1e-5, atol=1e-6)
F64 = dict(rtol=0, atol=1e-12)
SENSORS = ("other_agents_states", "laserscan")
OBS = ("dist_to_goal", "heading_ego_frame", "pref_speed", "radius", "laserscan")


def _jax_ckpt(dtype=jnp.float32):
    with np.load(CKPT) as z:
        return {k: jnp.asarray(z[k], dtype) for k in z.files}


def _inputs(seed, B, L, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-0.5, 0.5, (B, 3, L)).astype(dtype),
            rng.uniform(-4, 4, (B, 2)).astype(dtype), rng.uniform(-1, 1, (B, 2)).astype(dtype))


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("L,seed", [(512, 0), (64, 3)])
def test_seeded_inits_equal_jax(L, seed):
    for jfn, tfn in ((jnet.init_params, tnet.init_params),
                     (jnet.init_actor_critic_params, tnet.init_actor_critic_params)):
        for dtype in ("float32", "float64"):
            jp = jax.device_get(jfn(L, seed, getattr(jnp, dtype)))
            net = tfn(L, seed, getattr(torch, dtype), device="cpu")
            conv = convert.drl_long_params_from_numpy(jp, device="cpu")
            for port in (net, conv):
                assert port.dtype == getattr(torch, dtype)
                assert port.has_critic == ("critic_w" in jp)
                for name, want in jp.items():
                    layer, kind = name.rsplit("_", 1)
                    if name == "log_std":
                        got = port.log_std
                    else:
                        got = getattr(getattr(port, layer), "weight" if kind == "w" else "bias")
                        got = got.T if kind == "w" and got.dim() == 2 else got
                    np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("which", ["checkpoint", "init"])
def test_forward_float32_matches_jax(which):
    if which == "checkpoint":
        jp, net = _jax_ckpt(), tnet.load_params(device="cpu")
    else:
        jp, net = jnet.init_params(512, seed=1), tnet.init_params(512, seed=1, device="cpu")
    scan, goal, speed = _inputs(5, 64, 512)
    want = np.asarray(jax.jit(lambda *a: jnet.forward(jp, *a))(scan, goal, speed))
    got = tnet.forward(net, *(torch.as_tensor(a) for a in (scan, goal, speed)))
    assert got.dtype == torch.float32 and got.shape == (64, 2)
    np.testing.assert_allclose(_np(got), want, **F32)


def test_forward_and_actor_critic_float64_match_jax():
    jp = jnet.init_actor_critic_params(512, seed=2, dtype=jnp.float64)
    net = tnet.init_actor_critic_params(512, seed=2, dtype=torch.float64, device="cpu")
    scan, goal, speed = _inputs(6, 32, 512, np.float64)
    targs = [torch.as_tensor(a) for a in (scan, goal, speed)]
    np.testing.assert_allclose(_np(tnet.forward(net, *targs)),
                               np.asarray(jnet.forward(jp, scan, goal, speed)), **F64)
    for port, ref in zip(tnet.forward_actor_critic(net, *targs),
                         jnet.forward_actor_critic(jp, scan, goal, speed)):
        np.testing.assert_allclose(_np(port), np.asarray(ref), **F64)


def test_checkpoint_actor_critic_float32_matches_jax():
    jp, net = _jax_ckpt(), tnet.load_params(device="cpu")
    scan, goal, speed = _inputs(7, 48, 512)
    want = jax.jit(lambda *a: jnet.forward_actor_critic(jp, *a))(scan, goal, speed)
    got = tnet.forward_actor_critic(net, *(torch.as_tensor(a) for a in (scan, goal, speed)))
    for name, port, ref in zip(("mean", "log_std", "value"), got, want):
        np.testing.assert_allclose(_np(port), np.asarray(ref), err_msg=name, **F32)
    with pytest.raises(ValueError, match="critic"):
        tnet.forward_actor_critic(tnet.init_params(512, device="cpu"),
                                  torch.zeros(1, 3, 512), torch.zeros(1, 2), torch.zeros(1, 2))


class CNNPolicy(nn.Module):
    """The public repo's actor (``act_fea_cv1`` ... ``actor2``)."""

    def __init__(self, L):
        super().__init__()
        self.act_fea_cv1 = nn.Conv1d(3, 32, 5, 2, 1)
        self.act_fea_cv2 = nn.Conv1d(32, 32, 3, 2, 1)
        flat = 32 * tnet.conv_out_len(tnet.conv_out_len(L, 5, 2, 1), 3, 2, 1)
        self.act_fc1 = nn.Linear(flat, 256)
        self.act_fc2 = nn.Linear(256 + 4, 128)
        self.actor1 = nn.Linear(128, 1)
        self.actor2 = nn.Linear(128, 1)

    def forward(self, scan, goal, speed):
        h = torch.relu(self.act_fea_cv2(torch.relu(self.act_fea_cv1(scan))))
        h = torch.relu(self.act_fc1(h.reshape(h.shape[0], -1)))
        z = torch.relu(self.act_fc2(torch.cat([h, goal, speed], dim=-1)))
        return torch.cat([torch.sigmoid(self.actor1(z)), torch.tanh(self.actor2(z))], -1)


def test_torch_state_dict_conversion():
    """A ``CNNPolicy`` state dict through the port's converter runs bitwise
    as the module it came from, and equals the JAX package's conversion."""
    torch.manual_seed(0)
    policy = CNNPolicy(512)
    scan, goal, speed = (torch.as_tensor(a) for a in _inputs(8, 16, 512))
    arrays = tnet.convert_torch_state_dict(policy.state_dict())
    ref = jnet.convert_torch_state_dict(policy.state_dict())
    assert set(arrays) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(arrays[k], np.asarray(ref[k]), err_msg=k)
    net = tnet.DRLLongNet(arrays)
    assert not net.has_critic
    with torch.no_grad():
        np.testing.assert_array_equal(_np(net(scan, goal, speed)), _np(policy(scan, goal, speed)))
    np.testing.assert_allclose(_np(net(scan, goal, speed)),
                               np.asarray(jnet.forward(ref, scan.numpy(), goal.numpy(),
                                                       speed.numpy())), **F32)


def _laser_states(jcfg, seed, E, A=2):
    """JAX states with seeded laserscan histories (ranges in [0.1, 6],
    a fifth at the 6 m maximum) and random velocities."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-4, 4, (E, A, 2))
    goal = rng.uniform(-4, 4, (E, A, 2))
    st = tp.jax_batched_init(jcfg, pos, goal, np.full((E, A), 0.5), rng.uniform(0.5, 1.5, (E, A)),
                             rng.uniform(-np.pi, np.pi, (E, A)),
                             policy_id=np.full((E, A), DRL_LONG, np.int32))
    ranges = rng.uniform(0.1, 6.0, st.laserscan_history.shape)
    ranges[rng.rand(*ranges.shape) < 0.2] = 6.0
    dtype = st.pos.dtype
    return st.replace(laserscan_history=jnp.asarray(ranges, dtype),
                      laserscan_count=jnp.full((E, A), 3, jnp.int32),
                      vel=jnp.asarray(rng.uniform(-1, 1, (E, A, 2)), dtype))


@pytest.mark.parametrize("state_dtype,weights", [("float32", "float32"), ("float64", "float32"),
                                                 ("float64", "float64")])
def test_kernel_matches_jax(state_dtype, weights):
    jcfg, tcfg = (c(dtype=state_dtype, use_static_map=True) for c in (JCfg, TCfg))
    jp = _jax_ckpt(getattr(jnp, weights))
    net = convert.drl_long_params_from_numpy(jax.device_get(jp), device="cpu")
    jst = _laser_states(jcfg, 11, 16, 3)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jpol.drl_long_kernel(s, jcfg, {"drl_long": jp})))(jst))
    got = tpol.drl_long_kernel(tp.to_torch(jst), tcfg, {"drl_long": net})
    assert got.dtype == getattr(torch, state_dtype) and got.shape == want.shape
    atol = 1e-12 if weights == "float64" else 1e-6
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol)
    assert (want[..., 0] > 0).any() and (want[..., 1] != 0).any()


def test_kernel_float32_is_finite_and_in_bounds():
    """Float32 guards: every range at 0 or at the 6 m maximum, agents on
    their goals and stopped give finite actions inside the action box."""
    tcfg = TCfg(dtype="float32", use_static_map=True)
    jst = _laser_states(JCfg(dtype="float32", use_static_map=True), 12, 6)
    st = tp.to_torch(jst)
    hist = st.laserscan_history.clone()
    hist[0::2], hist[1::2] = 0.0, 6.0
    st = st.replace(laserscan_history=hist, goal=st.pos.clone(), vel=torch.zeros_like(st.vel))
    acts = tpol.drl_long_kernel(st, tcfg, {"drl_long": tnet.load_params(device="cpu")})
    assert torch.isfinite(acts).all()
    assert (acts[..., 0] >= 0).all() and (acts[..., 0] <= 1).all()
    assert (acts[..., 1].abs() <= tcfg.dt + 1e-7).all()


def _drl2_cfgs(L=512):
    kw = dict(dtype="float64", done_mode="evaluate", use_static_map=True, laserscan_length=L)
    return JCfg(**kw), TCfg(**kw)


def _drl2_inputs(jcfg, E):
    static = jgrid.load_static_map(jcfg, None)
    cells = jgrid.occupied_cell_list(static)
    pool = trc.scenario_pool(E, 2, seed=0, side_length=4.0)
    pid = np.array([DRL_LONG, RVO], np.int32)
    return static, cells, pool, pid


def test_laser_rollout_matches_jax():
    """``[DRL_LONG, RVO]`` on the empty 16 x 16 m map, 512 beams, the full
    pass, float64 state and weights, E = 4, 12 ``env_step``s."""
    jcfg, tcfg = _drl2_cfgs()
    static, cells, pool, pid = _drl2_inputs(jcfg, 4)
    jp = _jax_ckpt(jnp.float64)
    params = {"drl_long": convert.drl_long_params_from_numpy(jax.device_get(jp), device="cpu")}
    jst = jax.vmap(lambda c: jauto.state_from_case(jcfg, c, pid))(jnp.asarray(pool))
    tst = tp.to_torch(jst)
    active = (RVO, DRL_LONG)
    jstep = jax.jit(jax.vmap(lambda s: j_env_step(s, None, jcfg, {"drl_long": jp}, active,
                                                  SENSORS, OBS, static, cells)))
    names = ("obs", "rewards", "game_over")
    for t in range(12):
        jst, jobs, jrew, jgo, _ = jstep(jst)
        tst, tobs, trew, tgo, _ = t_env_step(tst, None, tcfg, params, active, SENSORS, OBS,
                                             static, cells)
        tp.assert_tree_close(dict(zip(names, (tobs, trew, tgo))),
                             dict(zip(names, (jobs, jrew, jgo))), path=f"step{t}",
                             rtol=0, atol=1e-9)
        tp.assert_states_close(tst, jst, rtol=0, atol=1e-9)
    assert (tst.speed[:, 0] > 0).any() and (tst.laserscan_history < 6.0).any()


def test_laser_server_matches_jax():
    """The drl2 configuration through ``AutoresetServer`` at E = 4, 64 beams,
    2 dispatches of 20 steps, float64."""
    jcfg, tcfg = _drl2_cfgs(64)
    static, cells, pool, pid = _drl2_inputs(jcfg, 4)
    jp = jax.device_get(jnet.init_params(64, seed=4, dtype=jnp.float64))
    kw = dict(num_envs=4, steps_per_dispatch=20, sensors=SENSORS, states_in_obs=OBS,
              static_map=static, static_cells=cells)
    jserver = JServer(jcfg, pool, pid, params={"drl_long": jax.tree.map(jnp.asarray, jp)}, **kw)
    tserver = TServer(tcfg, pool, pid, params={"drl_long": convert.drl_long_params_from_numpy(
        jp, device="cpu")}, device=tp.DEVICE, **kw)
    for _ in range(2):
        tp.assert_tree_close(tserver.dispatch(), jserver.dispatch(), path="out",
                             rtol=0, atol=1e-9)
    tp.assert_states_close(tserver.states(), jserver.states(), rtol=0, atol=1e-9)
    assert tserver.episodes_completed() == jserver.episodes_completed()
