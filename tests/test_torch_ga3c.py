"""The port's GA3C-CADRL network and policy against the JAX package on the
CPU: the loaded weights, the flat, structured and crop/pad forward routes,
the float32 and bfloat16 paths, a 4-agent rollout and the ``ga3c4_serving``
auto-reset loop.

Tolerances: float64 weights give probs and values within atol 1e-12 of the
JAX package and equal argmaxes; float32 within 1e-5, argmax equal wherever
the top two probs differ by more than 1e-5; bfloat16 agrees with float32 on
at least 98% of actions, as ``tests/test_ga3c.py`` holds the JAX package.
Rollouts in float64: discrete outputs and counters exact, floats within
atol 1e-9 (XLA's and torch's atan2/sin/cos differ by ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import convert
from gym_collision_avoidance_torch import env_step as t_env_step
from gym_collision_avoidance_torch.env import autoreset as tauto
from gym_collision_avoidance_torch.harness.serving import AutoresetServer as TServer
from gym_collision_avoidance_torch.models import ga3c_cadrl as tnet
from gym_collision_avoidance_torch.policies import ga3c as tga3c
from gym_collision_avoidance_torch.scenarios import random_cases as trc
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu import env_step as j_env_step
from gym_collision_avoidance_tpu.env import autoreset as jauto
from gym_collision_avoidance_tpu.harness.serving import AutoresetServer as JServer
from gym_collision_avoidance_tpu.models import ga3c_cadrl as jnet

GA3C = 6
CKPTS = ("iros18", "ppo_selfplay_4agent_curr")
TOL = dict(rtol=0, atol=1e-9)


def _obs(rng, B, width, seq_lens):
    """Seeded raw obs vectors of the network's layout: num_other_agents
    cycling through ``seq_lens``, plausible host scalars and other-agent
    rows, zero rows past each vector's count."""
    K = (width - 5) // 7
    x = np.zeros((B, width))
    x[:, 0] = np.resize(np.asarray(seq_lens, float), B)
    x[:, 1] = rng.uniform(0.0, 10.0, B)            # dist_to_goal
    x[:, 2] = rng.uniform(-np.pi, np.pi, B)        # heading_ego_frame
    x[:, 3] = rng.uniform(0.5, 1.5, B)             # pref_speed
    x[:, 4] = rng.uniform(0.2, 0.6, B)             # radius
    others = np.stack([rng.uniform(-5, 5, (B, K)), rng.uniform(-5, 5, (B, K)),
                       rng.uniform(-1, 1, (B, K)), rng.uniform(-1, 1, (B, K)),
                       rng.uniform(0.2, 0.6, (B, K)), rng.uniform(0.4, 1.2, (B, K)),
                       rng.uniform(0.0, 8.0, (B, K))], -1)
    others[np.arange(K)[None, :] >= x[:, :1]] = 0.0
    x[:, 5:] = others.reshape(B, -1)
    return x


def _nets(name, jdtype):
    jp = jnet.load_params(name, dtype=jdtype)
    return jp, convert.ga3c_params_from_numpy(jax.device_get(jp), device="cpu")


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


@pytest.mark.parametrize("name", CKPTS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_loaded_weights_equal_jax(name, dtype):
    jp = jnet.load_params(name, dtype=getattr(jnp, dtype))
    tp_ = tnet.load_params(name, dtype=dtype, device="cpu")
    conv = convert.ga3c_params_from_numpy(jax.device_get(jp), device="cpu")
    assert set(tp_.state_dict()) == set(jp) == set(conv.state_dict())
    for k, v in jp.items():
        want = np.asarray(v, np.float64)
        for port in (tp_, conv):
            got = port.state_dict()[k]
            want_dtype = torch.float32 if k in tnet.NORM_NAMES else getattr(torch, dtype)
            assert got.dtype == want_dtype, k
            np.testing.assert_array_equal(got.double().numpy(), want, err_msg=k)
    assert tp_.width == jp["input_avg"].shape[0]


@pytest.mark.parametrize("route", ["flat", "flat_cap3", "parts", "parts_sliced",
                                   "crop", "pad"])
def test_forward_float64_matches_jax(route):
    name = "ppo_selfplay_4agent_curr" if route == "crop" else "iros18"
    jp, net = _nets(name, jnp.float64)
    width = {"crop": 138, "pad": 26}.get(route, net.width)
    K = (width - 5) // 7
    x = _obs(np.random.RandomState(5), 64, width, range(K + 1))
    xt = torch.as_tensor(x)
    if route in ("flat", "flat_cap3", "crop", "pad"):
        cap = 3 if route == "flat_cap3" else None
        jprobs, jval = jnet.forward(jp, jnp.asarray(x), max_seq_len=cap)
        tprobs, tval = tnet.forward(net, xt, max_seq_len=cap)
    elif route == "parts":
        jprobs, jval = jnet.forward_parts(jp, jnp.asarray(x[:, :5]),
                                          jnp.asarray(x[:, 5:].reshape(-1, K, 7)))
        tprobs, tval = tnet.forward_parts(net, xt[:, :5], xt[:, 5:].reshape(-1, K, 7))
    else:   # the serving route: rows cut to 3 before normalising
        o = x[:, 5:].reshape(-1, K, 7)[:, :3]
        jprobs, jval = jnet.forward_parts(jp, jnp.asarray(x[:, :5]), jnp.asarray(o),
                                          max_seq_len=3, sensor_slots=K)
        tprobs, tval = tnet.forward_parts(net, xt[:, :5], torch.as_tensor(o),
                                          max_seq_len=3, sensor_slots=K)
    assert tprobs.dtype == torch.float64
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tprobs.argmax(-1).numpy(), np.asarray(jprobs).argmax(-1))


def test_forward_parts_logits_and_lstm_cell_match_jax():
    jp, net = _nets("ppo_selfplay_4agent_curr", jnp.float64)
    x = _obs(np.random.RandomState(6), 32, net.width, range(4))
    others = x[:, 5:].reshape(-1, 3, 7)
    jl, jv = jnet.forward_parts_logits(jp, jnp.asarray(x[:, :5]), jnp.asarray(others))
    tl, tv = tnet.forward_parts_logits(net, torch.as_tensor(x[:, :5]), torch.as_tensor(others))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-12)
    rng = np.random.RandomState(7)
    xt, c, h = rng.randn(16, 7), rng.randn(16, 64), rng.randn(16, 64)
    jc, jh = jnet.lstm_cell(jp, *(jnp.asarray(a) for a in (xt, c, h)))
    tc, th = tnet.lstm_cell(net, *(torch.as_tensor(a) for a in (xt, c, h)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-12)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-12)
    wide = torch.as_tensor(x)
    assert tnet.crop_to_width(wide, 10).shape[-1] == 10
    np.testing.assert_array_equal(tnet.crop_to_width(wide, 40)[:, 26:].numpy(), 0.0)


def test_forward_float32_matches_jax():
    jp, net = _nets("iros18", jnp.float32)
    x = _obs(np.random.RandomState(8), 512, net.width, range(20)).astype(np.float32)
    jprobs, jval = (np.asarray(a) for a in jnet.forward(jp, jnp.asarray(x)))
    tprobs, tval = tnet.forward(net, torch.as_tensor(x))
    assert tprobs.dtype == torch.float32
    np.testing.assert_allclose(tprobs.numpy(), jprobs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tval.numpy(), jval, rtol=1e-5, atol=1e-5)
    top2 = np.sort(jprobs, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(tprobs.argmax(-1).numpy()[clear], jprobs.argmax(-1)[clear])


def test_bfloat16_agrees_with_float32():
    x = torch.as_tensor(_obs(np.random.RandomState(13), 256, 138, range(20)), dtype=torch.float32)
    p32, _ = tnet.forward(tnet.load_params(device="cpu"), x)
    pbf, _ = tnet.forward(tnet.load_params(dtype=torch.bfloat16, device="cpu"), x)
    assert pbf.dtype == torch.bfloat16
    agree = (p32.argmax(-1) == pbf.argmax(-1)).double().mean().item()
    assert agree >= 0.98, agree
    np.testing.assert_allclose(_np(pbf), p32.numpy(), atol=0.05)


def _ga3c_cfgs(K=19, sorting="closest_last", **kw):
    kw = dict(dtype="float64", done_mode="evaluate", max_num_other_agents_observed=K,
              agent_sorting_method=sorting, **kw)
    return JCfg(**kw), TCfg(**kw)


@pytest.mark.parametrize("K,name", [(19, "iros18"), (3, "iros18"),
                                    (3, "ppo_selfplay_4agent_curr")])
def test_rollout_matches_jax(K, name):
    """E = 8 envs of 4 GA3C agents, 20 steps, float64: the structured route
    (19 slots, iros18; 3 slots, the 26-wide net) and the crop route (3
    slots into the 138-wide net)."""
    jcfg, tcfg = _ga3c_cfgs(K, "closest_last" if K == 19 else "closest_first")
    jp, net = _nets(name, jnp.float64)
    E, A = 8, 4
    pool = trc.scenario_pool(E, A, seed=3, side_length=4.0)
    pid = np.full(A, GA3C, np.int32)
    jst = jax.vmap(lambda c: jauto.state_from_case(jcfg, c, pid))(jnp.asarray(pool))
    tst = tp.to_torch(jst)
    jstep = jax.jit(jax.vmap(lambda s: j_env_step(s, None, jcfg, {"ga3c_cadrl": jp}, (GA3C,))))
    params = {"ga3c_cadrl": net}
    names = ("obs", "rewards", "game_over")
    for t in range(20):
        jst, jobs, jrew, jgo, _ = jstep(jst)
        tst, tobs, trew, tgo, _ = t_env_step(tst, None, tcfg, params, (GA3C,))
        tp.assert_tree_close(dict(zip(names, (tobs, trew, tgo))),
                             dict(zip(names, (jobs, jrew, jgo))), path=f"step{t}", **TOL)
        tp.assert_states_close(tst, jst, **TOL)
    # the agents moved and saw each other
    assert (tst.num_other_agents_observed > 0).any() and (tst.speed > 0).any()


def test_serving_loop_matches_jax():
    """The ``ga3c4_serving`` configuration at E = 8, float64 (weights too),
    120 steps: every env resets at least once."""
    jcfg, tcfg = _ga3c_cfgs()
    jp, net = _nets("iros18", jnp.float64)
    E, A, N = 8, 4, 8
    pool = trc.scenario_pool(N, A, seed=0, side_length=4.0)
    pid = np.full(A, GA3C, np.int32)
    jstep = jax.jit(jax.vmap(jauto.make_autoreset_step(
        jcfg, jnp.asarray(pool), pid, (GA3C,), params={"ga3c_cadrl": jp})))
    jst = jax.vmap(lambda c: jauto.state_from_case(jcfg, c, pid))(jnp.asarray(pool))
    jc = jnp.arange(E, dtype=jnp.int32)
    tstep = tauto.make_autoreset_step(tcfg, pool, pid, (GA3C,), params={"ga3c_cadrl": net},
                                      device=tp.DEVICE)
    tst = tauto.state_from_case(tcfg, pool, pid, device=tp.DEVICE)
    tc = torch.arange(E, dtype=torch.int32)
    names = ("counter", "obs", "rewards", "game_over")
    for t in range(120):
        jst, jc, jobs, jrew, jgo = jstep(jst, jc)
        tst, tc, tobs, trew, tgo = tstep(tst, tc)
        tp.assert_tree_close(dict(zip(names, (tc, tobs, trew, tgo))),
                             dict(zip(names, (jc, jobs, jrew, jgo))), path=f"step{t}", **TOL)
    tp.assert_states_close(tst, jst, **TOL)
    assert (np.asarray(jc) - np.arange(E)).min() >= 1


def test_server_matches_jax_server():
    jcfg, tcfg = _ga3c_cfgs()
    jp, net = _nets("iros18", jnp.float64)
    pool = trc.scenario_pool(8, 4, seed=0, side_length=4.0)
    pid = np.full(4, GA3C, np.int32)
    kw = dict(num_envs=8, steps_per_dispatch=30, collect=("other_agents_states",))
    jserver = JServer(jcfg, pool, pid, params={"ga3c_cadrl": jp}, **kw)
    tserver = TServer(tcfg, pool, pid, params={"ga3c_cadrl": net}, device=tp.DEVICE, **kw)
    for _ in range(2):
        tp.assert_tree_close(tserver.dispatch(), jserver.dispatch(), path="out", **TOL)
    tp.assert_states_close(tserver.states(), jserver.states(), **TOL)
    assert tserver.episodes_completed() == jserver.episodes_completed()


def test_kernel_reads_float32_obs_and_keeps_callers_module():
    """A float64 state is rounded through float32 before the network, as in
    the JAX kernel; the step's copy of the weights leaves the caller's
    module where it was."""
    _, tcfg = _ga3c_cfgs()
    net = tnet.load_params(dtype=torch.float64, device="cpu")
    pool = trc.scenario_pool(4, 4, seed=1, side_length=4.0)
    st = tauto.state_from_case(tcfg, pool, np.full(4, GA3C, np.int32), device="cpu")
    st = t_env_step(st, None, tcfg, {"ga3c_cadrl": net}, (GA3C,))[0]
    nudged = st.replace(dist_to_goal=st.dist_to_goal + 1e-12)     # below f32's resolution
    params = {"ga3c_cadrl": net}
    torch.testing.assert_close(tga3c.ga3c_cadrl_probs(nudged, params),
                               tga3c.ga3c_cadrl_probs(st, params), rtol=0, atol=0)
    tauto.make_autoreset_step(tcfg, pool, np.full(4, GA3C, np.int32), (GA3C,),
                              params=params, device="cpu")
    assert params["ga3c_cadrl"] is net
