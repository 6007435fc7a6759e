"""The port's SA-CADRL (value net and 47-candidate lookahead) against the JAX
package on the CPU.

The JAX side runs jitted (the compiled step is what the port follows: its
``round(d * 100) / 100``, filtered-velocity quotient and standardisation
are reciprocal products there), vmapped per env and per ego agent; the port
runs the whole ``[E, A]`` batch at once.  Tolerances:

* value nets in float64 within atol 1e-12 of JAX, float32 within 1e-5;
* the encoded ``[E, A, N, 31]`` batch and every float aux field within
  atol 1e-9 in float64 (XLA's and torch's atan2/sin/cos/pow differ by
  ulps), 1e-4 in float32; discrete aux fields equal;
* candidate values within atol 1e-9 (float64) / 1e-5 (float32); actions
  equal within atol 1e-9 / 1e-5 wherever JAX's top two values differ by
  more than 1e-9 / 1e-5 or are exactly equal (a near-tie may flip the
  argmax), which must hold for at least 95% of agents;
* rollouts and the auto-reset loop in float64: discrete outputs and
  counters equal, floats within atol 1e-9, ``heading_ego_frame`` modulo
  2 pi (an agent that overshoots its goal faces it at +-pi, where an ulp
  of atan2 picks the end of the range).

The float32 references run with JAX's x64 mode off, the mode a float32
deployment runs in (with it on, JAX computes part of a float32 step in
float64).
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
from gym_collision_avoidance_torch.core import maths as tmaths
from gym_collision_avoidance_torch.env import autoreset as tauto
from gym_collision_avoidance_torch.harness.serving import AutoresetServer as TServer
from gym_collision_avoidance_torch.models import cadrl as tnet
from gym_collision_avoidance_torch.obs import sensors as tsensors
from gym_collision_avoidance_torch.policies import cadrl as tcad
from gym_collision_avoidance_torch.scenarios import random_cases as trc
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu import env_step as j_env_step
from gym_collision_avoidance_tpu.core import dynamics as jdyn
from gym_collision_avoidance_tpu.core import maths as jmaths
from gym_collision_avoidance_tpu.env import autoreset as jauto
from gym_collision_avoidance_tpu.harness.serving import AutoresetServer as JServer
from gym_collision_avoidance_tpu.models import cadrl as jnet
from gym_collision_avoidance_tpu.obs import sensors as jsensors
from gym_collision_avoidance_tpu.policies import cadrl as jcad

CADRL = 7
MODES = {"no_constr": ("no_constr", {}),
         "rotate_constr_right": ("rotate_constr_right",
                                 dict(cadrl_mode="rotate_constr", cadrl_passing_side="right"))}
F64 = dict(feat=1e-9, value=1e-9, tie=1e-9, action=1e-9)
F32 = dict(feat=1e-4, value=1e-5, tie=1e-5, action=1e-5)
ANGLES = ("heading_ego_frame",)


def _cfgs(mode="no_constr", dtype="float64", **kw):
    kw = dict(dtype=dtype, **MODES[mode][1], **kw)
    return JCfg(**kw), TCfg(**kw)


def _nets(mode, dtype):
    jp = jnet.load_params(MODES[mode][0], dtype=getattr(jnp, dtype))
    return jp, convert.cadrl_params_from_numpy(jax.device_get(jp), device="cpu")


def _x31(seed, B):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 31) * 2.0
    x[:, 0] = rng.uniform(0, 30, B)
    return x


def _states(seed, E, A, jcfg):
    """Seeded JAX states of CADRL agents with random velocities, past
    velocities and turning directions, and the edge cases: env 0's agent 0
    sees no other (the fallback action); in env 1 agents 1 and 2 coincide
    (ties on both rank keys, broken by index) unless the passing-side rule
    is on (for coincident agents it tests the sign of an angle that is 0 up
    to rounding); in env 2 two others' clearance
    rounds to the same cm (tie on the rounded key); env 3 has a stopped
    agent, env 4 an agent 3 cm from its goal, env 5 a goal 40 m away (the
    encoder's 30 m clip)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-4, 4, (E, A, 2))
    goal = rng.uniform(-4, 4, (E, A, 2))
    radius = rng.uniform(0.2, 0.6, (E, A))
    pref = rng.uniform(0.5, 1.5, (E, A))
    heading = rng.uniform(-np.pi, np.pi, (E, A))
    valid = rng.rand(E, A) > 0.15
    valid[:, 0] = True
    valid[0, 1:] = False
    vel = rng.uniform(-1, 1, (E, A, 2))
    past_vel = rng.uniform(-1, 1, (E, A, 2, 2))
    if A >= 3:
        valid[1:3, :3] = True
        if jcfg.cadrl_passing_side == "none":
            pos[1, 2], radius[1, 2] = pos[1, 1], radius[1, 1]
        radius[2, :3] = 0.3
        pos[2, 1] = pos[2, 0] + [1.8312, 0.0]          # clearance 1.2312
        pos[2, 2] = pos[2, 0] + [0.0, -1.8338]         # clearance 1.2338
    vel[3, 1], past_vel[3, 1] = 0.0, 0.0
    goal[4, 0] = pos[4, 0] + [0.03, 0.0]
    goal[5, A - 1] = pos[5, A - 1] + [40.0, 0.0]
    st = tp.jax_batched_init(jcfg, pos, goal, radius, pref, heading,
                             policy_id=np.full((E, A), CADRL, np.int32), valid=valid)
    dtype = st.pos.dtype
    st = st.replace(vel=jnp.asarray(vel, dtype), past_vel=jnp.asarray(past_vel, dtype),
                    turning_dir=jnp.asarray(rng.uniform(-1, 1, (E, A)), dtype))
    prll, orth, d2g, he, ve = jdyn.update_ego_frame(st.pos, st.goal, st.heading, st.vel)
    return st.replace(ref_prll=prll, ref_orth=orth, dist_to_goal=d2g, heading_ego_frame=he,
                      vel_ego_frame=ve)


def _jax_prepare_fn(jcfg):
    def prepare(s):
        A = s.pos.shape[0]
        return jax.vmap(lambda h: jcad._cadrl_prepare(h, s, jcfg))(jnp.arange(A))
    return jax.jit(jax.vmap(prepare))


def _jax_values(aux, nn_raw):
    """``_cadrl_finish``'s candidate values (``policies/cadrl.py:674-690``
    of the JAX package), over the batch axes."""
    G, DN = jcad.GAMMA, jcad.DT_NORMAL
    nn_vals = jnp.minimum(G ** (aux["dist_col"] / DN), jnp.clip(nn_raw, -0.25, 1.0))
    sv = jnp.where(aux["if_collide"], 0.0,
                   jnp.where(aux["reached"], G ** (aux["d_next"] / DN), nn_vals))
    dtf, pref = aux["dt_forward"][..., None], aux["pref"][..., None]
    dt_vec = 0.2 * dtf + 0.8 * aux["action_speed"] / pref * dtf
    values = aux["action_rewards"] + G ** (dt_vec * pref / DN) * sv
    return jnp.where(aux["action_valid"], values, -jnp.inf)


def _jax_reference_fn(jcfg, jp):
    """``states -> (encoded batch, aux, candidate values, actions)`` of
    JAX, jitted once."""
    prepare = _jax_prepare_fn(jcfg)

    @jax.jit
    def run(jst):
        states_nn, aux = prepare(jst)
        nn_raw = jnet.forward_raw(jp, states_nn)
        return (states_nn, aux, _jax_values(aux, nn_raw),
                jax.vmap(jax.vmap(jcad._cadrl_finish))(aux, nn_raw))
    return lambda jst: jax.device_get(run(jst))


def _close(got, want, atol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


# ------------------------------------------------------------ value nets

@pytest.mark.parametrize("mode", list(MODES))
def test_value_net_float64_matches_jax(mode):
    jp, net = _nets(mode, "float64")
    loaded = tnet.load_params(MODES[mode][0], dtype=torch.float64, device="cpu")
    for k in tnet.WEIGHT_NAMES + tnet.NORM_NAMES:
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(net.state_dict()[k].numpy(), np.asarray(jp[k]))
    x = _x31(3, 256)
    want = np.asarray(jax.jit(lambda v: jnet.forward_raw(jp, v))(jnp.asarray(x)))
    for port in (net, loaded):
        got = port.forward_raw(torch.as_tensor(x))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # [E, A, N, 31] in one call, as the policy runs it
    got4 = net.forward_raw(torch.as_tensor(x.reshape(2, 4, 32, 31)))
    np.testing.assert_allclose(got4.numpy().reshape(-1), want, rtol=0, atol=1e-12)


def test_value_net_float32_matches_jax():
    x = _x31(4, 512).astype(np.float32)
    with jax.enable_x64(False):
        jp = jnet.load_params("no_constr", dtype=jnp.float32)
        want = np.asarray(jax.jit(lambda v: jnet.forward_raw(jp, v))(jnp.asarray(x)))
    net = tnet.load_params(device="cpu")
    got = net.forward_raw(torch.as_tensor(x))
    assert got.dtype == torch.float32 and net.inv_std.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_value_net_loader_names_and_dtypes():
    with pytest.raises(ValueError, match="float32 or float64"):
        tnet.load_params(dtype=torch.bfloat16, device="cpu")
    net = tnet.load_params(tnet.CHECKPOINTS["rotate_constr_right"], dtype="float64",
                           device="cpu")
    assert net.dtype == torch.float64 and net.W0.shape == (31, 200)


# ------------------------------------------------------------ the pieces

def test_mod_wrap_matches_jnp_remainder():
    """``torch.remainder`` is the floor-mod ``jnp.remainder`` is, bitwise, on
    negative angles, exact multiples of 2 pi and their neighbours."""
    k = np.arange(-4, 5)
    a = np.concatenate([k * 2 * np.pi, k * 2 * np.pi - np.pi, k * np.pi + 1e-9,
                        np.random.RandomState(0).uniform(-20, 20, 64), [0.0, -0.0]])
    for dtype in (np.float64, np.float32):
        x = a.astype(dtype)
        want = np.asarray(jax.jit(jcad._mod_wrap)(jnp.asarray(x)))
        got = tcad._mod_wrap(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_lex_rank_matches_jax_with_ties():
    """The pairwise rank on keys with many exact ties, including the rounded
    clearance key of ``_select_others``: equal to JAX's and to a stable
    lexsort."""
    rng = np.random.RandomState(1)
    d = rng.choice([0.1234, 0.1236, 0.5, 1.0, 2.25], (32, 9))
    key1 = np.where(rng.rand(32, 9) > 0.2, -(np.round(d * 100) * 0.01), -np.inf)
    key2 = np.where(np.isfinite(key1), rng.choice([-1.0, 0.0, 0.5], (32, 9)), -np.inf)
    idx = np.arange(9)
    want = np.asarray(jsensors._lex_rank((jnp.asarray(key1), jnp.asarray(key2)),
                                         jnp.asarray(idx)))
    got = tsensors._lex_rank((torch.as_tensor(key1), torch.as_tensor(key2)),
                             torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    for row in range(32):
        order = np.lexsort((idx, key2[row], key1[row]))
        np.testing.assert_array_equal(np.argsort(got[row]), order)
    assert (np.diff(np.sort(key1, axis=1), axis=1) == 0).any()


def test_filter_vel_matches_jax():
    """``filter_vel`` against JAX's jitted call with the closed-over weights
    of SA-CADRL (a product with 1 / (2 dt)), on zero and -0.0 velocities
    too.  XLA:CPU contracts the two-term weighted sum into an FMA that no
    HLO shows, so the speeds agree to 2 ulps of the larger weighted sample
    (rtol 4.5e-16 plus atol 2e-16 in float64, rtol 2.4e-7 plus atol 1e-7 in
    float32), not bitwise; angles within 1e-15 / 1e-6."""
    rng = np.random.RandomState(2)
    past = rng.uniform(-1, 1, (64, 3, 2, 2))
    past[0] = 0.0
    past[1, :, :, 1] = -0.0
    for dtype, dt in ((np.float64, 0.2), (np.float32, 0.1)):
        x = past.astype(dtype)
        const = jnp.full((3, 2), dt, dtype)
        want = np.asarray(jax.jit(lambda p, c=const: jmaths.filter_vel(c, p))(jnp.asarray(x)))
        got = tmaths.filter_vel(dt, torch.as_tensor(x)).numpy()
        assert got.dtype == dtype
        f64 = dtype == np.float64
        np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=4.5e-16 if f64 else 2.4e-7,
                                   atol=2e-16 if f64 else 1e-7)
        np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0,
                                   atol=1e-15 if f64 else 1e-6)


def test_passing_side_cost_fires():
    """The overtaking geometry of ``tests/test_cadrl.py`` where the 'right'
    rule penalises candidates: the port's cost equals JAX's and is nonzero."""
    agent = np.array([0.0, 0.0, 1.2, 0.0, 0.0, 1.2, 10.0, 0.0, 0.3, 0.0])
    other = np.array([1.5, 0.6, 0.6, 0.0, 0.0, 0.6, 10.0, 0.6, 0.3, 0.0])
    others = np.zeros((3, 10))
    others[0] = other
    acts = np.zeros((3, 2))
    acts[0] = [0.6, 0.0]
    present = np.array([True, False, False])
    sp, hd, _valid = jcad._candidate_actions_rotate(jnp.asarray(agent))
    j_next = jcad._update_states(jnp.asarray(agent), (sp, hd), 1.0)
    j_others = jcad._update_states_others(jnp.asarray(others), jnp.asarray(acts), 1.0)
    want = np.asarray(jcad._passing_side_cost(jnp.asarray(agent), j_next, jnp.asarray(others),
                                              j_others, jnp.asarray(present), "right"))
    a = torch.as_tensor(agent)
    t_next = tcad._update_states(a, torch.as_tensor(np.asarray(sp)),
                                 torch.as_tensor(np.asarray(hd)), torch.tensor(1.0,
                                                                              dtype=a.dtype))
    t_others = tcad._update_states_others(torch.as_tensor(others), torch.as_tensor(acts),
                                          torch.tensor(1.0, dtype=a.dtype))
    got = tcad._passing_side_cost(a, t_next, torch.as_tensor(others), t_others,
                                  torch.as_tensor(present), "right").numpy()
    assert np.any(want != 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# --------------------------------------------------- lookahead against JAX

@pytest.mark.parametrize("A", [2, 3, 4, 6])
@pytest.mark.parametrize("mode", list(MODES))
def test_prepare_matches_jax(mode, A):
    """The encoded ``[E, A, N, 31]`` batch and every aux field, float64."""
    jcfg, tcfg = _cfgs(mode)
    jst = _states(10 + A, 12, A, jcfg)
    states_nn, aux = jax.device_get(_jax_prepare_fn(jcfg)(jst))
    t_nn, t_aux = tcad._cadrl_prepare(tp.to_torch(jst), tcfg)
    _close(t_nn, states_nn, F64["feat"], "states_nn")
    assert set(t_aux) == set(aux)
    for k in aux:
        _close(t_aux[k], aux[k], F64["feat"], k)
    n = aux["num_present"]
    assert (n == 0).any() and (n == min(3, A - 1)).any()
    assert aux["if_collide"].any() and (~aux["if_collide"]).any()
    if mode != "no_constr":
        assert (~aux["action_valid"]).any()


def _values_and_actions(jst, jcfg, tcfg, jp, net, tol):
    states_nn, aux, values, actions = _jax_reference_fn(jcfg, jp)(jst)
    tst = tp.to_torch(jst)
    t_values, _aux = tcad.cadrl_values(tst, tcfg, {"cadrl": net})
    t_actions = tcad.cadrl_kernel(tst, tcfg, {"cadrl": net})
    _close(t_values, values, tol["value"], "values")
    # the helper reproduces JAX's own argmax
    best = values.argmax(-1)
    picked = np.take_along_axis(aux["action_speed"], best[..., None], -1)[..., 0]
    seen = aux["num_present"] > 0
    np.testing.assert_array_equal(actions[..., 0][seen], picked[seen])
    top2 = np.sort(values, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    # an exact tie (duplicate candidates, colliding rows) goes to the first
    # index on both sides
    clear = (margin > tol["tie"]) | (margin == 0) | ~seen
    assert clear.mean() >= 0.95, clear.mean()
    np.testing.assert_allclose(t_actions.numpy()[clear], actions[clear], rtol=0,
                               atol=tol["action"])
    return int(clear.sum()), clear.size


@pytest.mark.parametrize("mode", list(MODES))
def test_values_and_actions_float64_match_jax(mode):
    jcfg, tcfg = _cfgs(mode)
    jp, net = _nets(mode, "float64")
    compared, agents = _values_and_actions(_states(21, 16, 4, jcfg), jcfg, tcfg, jp, net, F64)
    assert compared >= 0.95 * agents


@pytest.mark.parametrize("mode", list(MODES))
def test_values_and_actions_float32_match_jax(mode):
    with jax.enable_x64(False):
        jcfg, tcfg = _cfgs(mode, "float32")
        jp, net = _nets(mode, "float32")
        jst = _states(22, 16, 4, jcfg)
        assert jst.pos.dtype == jnp.float32
        _values_and_actions(jst, jcfg, tcfg, jp, net, F32)


def test_state_values_match_jax():
    jcfg, tcfg = _cfgs()
    jp, net = _nets("no_constr", "float64")
    jst = _states(23, 12, 4, jcfg)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jcad.cadrl_state_values(s, jcfg, {"cadrl": jp})))(jst))
    got = tcad.cadrl_state_values(tp.to_torch(jst), tcfg, {"cadrl": net})
    _close(got, want, 1e-12, "state values")
    _close(tcad.cadrl_state_values(tp.to_torch(jst), tcfg, net), want, 1e-12, "net only")


def test_float32_outputs_are_finite():
    """Float32 guards: coincident agents, agents on their goal, stopped
    agents and a lone agent give finite actions and values (the -inf rows
    of rotate_constr aside)."""
    for mode in MODES:
        _, tcfg = _cfgs(mode, "float32")
        net = tnet.load_params(MODES[mode][0], device="cpu")
        rng = np.random.RandomState(5)
        E, A = 6, 4
        pos = rng.uniform(-2, 2, (E, A, 2))
        goal = rng.uniform(-2, 2, (E, A, 2))
        pos[0, 1] = pos[0, 0]                    # coincident
        goal[1] = pos[1]                         # every agent on its goal
        valid = np.ones((E, A), bool)
        valid[2, 1:] = False                     # a lone agent
        from gym_collision_avoidance_torch import init_state
        st = init_state(tcfg, pos, goal, np.full((E, A), 0.3), np.ones((E, A)),
                        policy_id=np.full((E, A), CADRL, np.int32), valid=valid, device="cpu")
        values, aux = tcad.cadrl_values(st, tcfg, {"cadrl": net})
        acts = tcad.cadrl_kernel(st, tcfg, {"cadrl": net})
        assert torch.isfinite(acts).all()
        assert torch.isfinite(values[aux["action_valid"]]).all()
        assert not torch.isnan(values).any()


# ------------------------------------------------------------ stepping

def _pool_states(jcfg, seed, E=8, A=4):
    pool = trc.scenario_pool(E, A, seed=seed, side_length=4.0)
    pid = np.full(A, CADRL, np.int32)
    return jax.vmap(lambda c: jauto.state_from_case(jcfg, c, pid))(jnp.asarray(pool))


def test_rollout_matches_jax():
    """E = 8 envs of 4 CADRL agents (no_constr), 20 ``env_step``s, float64."""
    jcfg, tcfg = _cfgs(done_mode="evaluate")
    jp, net = _nets("no_constr", "float64")
    jst = _pool_states(jcfg, 3)
    tst = tp.to_torch(jst)
    jstep = jax.jit(jax.vmap(lambda s: j_env_step(s, None, jcfg, {"cadrl": jp}, (CADRL,))))
    names = ("obs", "rewards", "game_over")
    for t in range(20):
        jst, jobs, jrew, jgo, _ = jstep(jst)
        tst, tobs, trew, tgo, _ = t_env_step(tst, None, tcfg, {"cadrl": net}, (CADRL,))
        tp.assert_tree_close(dict(zip(names, (tobs, trew, tgo))),
                             dict(zip(names, (jobs, jrew, jgo))), path=f"step{t}",
                             rtol=0, atol=1e-9, angles=ANGLES)
        tp.assert_states_close(tst, jst, rtol=0, atol=1e-9, angles=ANGLES)
    assert (tst.speed > 0).any() and (tst.num_other_agents_observed > 0).any()


def test_rotate_trajectory_matches_jax_step_by_step():
    """``rotate_constr`` with the 'right' passing side along a 20-step JAX
    trajectory (E = 8, float64), each step from JAX's state.  The rule's
    same-direction tests compare the encoded heading with 0, and a "desired"
    candidate (straight at the goal) encodes a heading that is 0 up to
    rounding: its penalty 0.5 * gcp may flip between the packages.  So the
    candidate values agree within 1e-9 except where the rewards differ by
    exactly that penalty (at most 2% of candidates); actions agree on every
    agent with no flipped candidate whose top two values are clear (1e-9)
    or exactly tied, at least 85% of them (agents stopped near their goals
    hold many near-ties); the step's other outputs agree on every env whose
    agents all took JAX's action."""
    jcfg, tcfg = _cfgs("rotate_constr_right", done_mode="evaluate")
    jp, net = _nets("rotate_constr_right", "float64")
    params = {"cadrl": net}
    jst = _pool_states(jcfg, 3)
    jstep = jax.jit(jax.vmap(lambda s: j_env_step(s, None, jcfg, {"cadrl": jp}, (CADRL,))))
    reference = _jax_reference_fn(jcfg, jp)
    flipped_total = candidates = compared = 0
    for t in range(20):
        _nn, aux, values, actions = reference(jst)
        tst = tp.to_torch(jst)
        t_values, t_aux = tcad.cadrl_values(tst, tcfg, params)
        gcp = tcad._gcp(tcad._ego_s10(tst)).numpy()[..., None]
        off = t_aux["action_rewards"].numpy() - aux["action_rewards"]
        flip = (np.isclose(np.abs(off), tcad.PASSING_SIDE_WEIGHT * gcp, rtol=1e-9, atol=0)
                & (gcp > 0))
        np.testing.assert_allclose(t_values.numpy()[~flip], values[~flip], rtol=0, atol=1e-9,
                                   err_msg=f"step{t}")
        flipped_total += int(flip.sum())
        candidates += flip.size
        top2 = np.sort(values, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        clear = ((margin > 1e-9) | (margin == 0)) & ~flip.any(-1)
        t_actions = tcad.cadrl_kernel(tst, tcfg, params).numpy()
        np.testing.assert_allclose(t_actions[clear], actions[clear], rtol=0, atol=1e-9)
        compared += int(clear.sum())
        same = np.isclose(t_actions, actions, rtol=0, atol=1e-9).all(-1).all(-1)
        jnext, jobs, jrew, jgo, _ = jstep(jst)
        tnext, tobs, trew, tgo, _ = t_env_step(tst, None, tcfg, params, (CADRL,))
        names = ("obs", "rewards", "game_over")
        port = dict(zip(names, (tobs, trew, tgo)))
        ref = dict(zip(names, (jobs, jrew, jgo)))
        tp.assert_tree_close(jax.tree.map(lambda x: x.detach().numpy()[same], port),
                             jax.tree.map(lambda x: np.asarray(x)[same], ref),
                             path=f"step{t}", rtol=0, atol=1e-9, angles=ANGLES)
        jst = jnext
    assert flipped_total <= 0.02 * candidates, (flipped_total, candidates)
    assert compared >= 0.85 * 20 * 8 * 4, compared


def test_autoreset_loop_and_server_match_jax():
    """``make_autoreset_step`` (60 steps) and ``AutoresetServer`` (2
    dispatches of 30) with CADRL agents at E = 8, float64: every env
    resets at least once."""
    jcfg, tcfg = _cfgs(done_mode="evaluate")
    jp, net = _nets("no_constr", "float64")
    E, A = 8, 4
    pool = trc.scenario_pool(E, A, seed=0, side_length=4.0)
    pid = np.full(A, CADRL, np.int32)
    jstep = jax.jit(jax.vmap(jauto.make_autoreset_step(
        jcfg, jnp.asarray(pool), pid, (CADRL,), params={"cadrl": jp})))
    jst = jax.vmap(lambda c: jauto.state_from_case(jcfg, c, pid))(jnp.asarray(pool))
    jc = jnp.arange(E, dtype=jnp.int32)
    tstep = tauto.make_autoreset_step(tcfg, pool, pid, (CADRL,), params={"cadrl": net},
                                      device=tp.DEVICE)
    tst = tauto.state_from_case(tcfg, pool, pid, device=tp.DEVICE)
    tc = torch.arange(E, dtype=torch.int32)
    names = ("counter", "obs", "rewards", "game_over")
    for t in range(60):
        jst, jc, jobs, jrew, jgo = jstep(jst, jc)
        tst, tc, tobs, trew, tgo = tstep(tst, tc)
        tp.assert_tree_close(dict(zip(names, (tc, tobs, trew, tgo))),
                             dict(zip(names, (jc, jobs, jrew, jgo))), path=f"step{t}",
                             rtol=0, atol=1e-9, angles=ANGLES)
    tp.assert_states_close(tst, jst, rtol=0, atol=1e-9, angles=ANGLES)
    assert (np.asarray(jc) - np.arange(E)).min() >= 1

    kw = dict(num_envs=E, steps_per_dispatch=30, collect=("other_agents_states",))
    jserver = JServer(jcfg, pool, pid, params={"cadrl": jp}, **kw)
    tserver = TServer(tcfg, pool, pid, params={"cadrl": net}, device=tp.DEVICE, **kw)
    for _ in range(2):
        tp.assert_tree_close(tserver.dispatch(), jserver.dispatch(), path="out",
                             rtol=0, atol=1e-9, angles=ANGLES)
    tp.assert_states_close(tserver.states(), jserver.states(), rtol=0, atol=1e-9,
                           angles=ANGLES)
    assert tserver.episodes_completed() == jserver.episodes_completed() > 0


def test_kernel_needs_its_weights():
    _, tcfg = _cfgs()
    st = tauto.state_from_case(tcfg, trc.scenario_pool(2, 4, seed=0), np.full(4, CADRL, np.int32),
                               device="cpu")
    with pytest.raises(ValueError, match="params\\['cadrl'\\]"):
        tcad.cadrl_kernel(st, tcfg, None)
