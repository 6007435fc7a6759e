"""The port's PPO trainer against the JAX package's on the CPU.

Both trainers get the same weights (through ``convert``), the same env
carry and the same noise: the test rebuilds JAX's draws from JAX's keys
(``split(rng)``, ``split(rng_roll, T)``, ``fold_in(key_t, id)``,
``split(rng_perm, epochs)``) and hands them to the port's ``train_step``.
Families at E = 8 envs, T = 6 steps, 2 epochs of 2 minibatches: ``mlp`` (2
agents, NonCoop traffic), ``ga3c`` (self-play, 3 agents) and ``drl_long`` (2
agents against RVO, 128 beams).  JAX runs float32 with x64 off, as the
trainer runs on an accelerator (with x64 on, its numpy-float64 constants
would lift the Gaussian losses to float64).

Tolerances:

* rollout: ``done``, ``game_over``, ``alive`` and GA3C's action indices
  equal (no near-tie occurred at these seeds); floats within rtol 1e-5 /
  atol 2e-6; GAE within atol 1e-5;
* ``loss_fn``: float32 loss within rtol 1e-5, each gradient within atol
  1e-5 of its tensor's largest JAX entry (float32 sums over the 144-row
  minibatch in another order); float64 loss within rtol 1e-12, gradients
  within 1e-10 of their largest entry;
* params after a ``train_step`` (4 Adam steps at lr 3e-4) within rtol 1e-5 /
  atol 1e-4, a third of one Adam step: where a gradient is rounding noise
  (GA3C's 1e-2 heads leave trunk gradients near Adam's eps) the normalised
  step amplifies the rounding, while a wrong gradient moves an element by
  about lr per step; the optimizer's moments within rtol 1e-3 / atol 1e-3
  of their tensor's largest entry (after the first minibatch they average
  gradients taken at those slightly different weights); metrics within
  rtol 1e-5 / atol 1e-6;
  env states within rtol/atol 1e-5, counters equal;
* the optimizer on its own against optax: float32 bitwise (it computes
  optax's operations in optax's order), float64 within rtol 1e-12;
* checkpoint resume: bitwise.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig as TCfg
from gym_collision_avoidance_torch import convert
from gym_collision_avoidance_torch.core import maths
from gym_collision_avoidance_torch.models import drl_long as tdrl
from gym_collision_avoidance_torch.models import ga3c_cadrl as tga3c
from gym_collision_avoidance_torch.train import optim
from gym_collision_avoidance_torch.train import ppo as tppo
from gym_collision_avoidance_torch.utils import checkpoint as ckpt
from gym_collision_avoidance_tpu import EnvConfig as JCfg
from gym_collision_avoidance_tpu.models import ga3c_cadrl as jga3c
from gym_collision_avoidance_tpu.train import ppo as jppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NONCOOP, RVO = 2, 8
E, T, EPOCHS, N_MB = 8, 6, 2, 2
DRL_CFG = dict(dtype="float32", done_mode="learning", reward_time_step=-0.01,
               laserscan_length=128, use_static_map=True)
FAMILIES = {
    "mlp": dict(num_agents=2, self_play=False, traffic_policy=NONCOOP),
    "ga3c": dict(num_agents=3, self_play=True, traffic_policy=NONCOOP),
    "drl_long": dict(num_agents=2, self_play=False, traffic_policy=RVO),
}
ROLL_F32 = dict(rtol=1e-5, atol=2e-6)
PARAMS_F32 = dict(rtol=1e-5, atol=1e-4)
METRICS = dict(rtol=1e-5, atol=1e-6)


def _closure(fn):
    """The JAX trainer's inner functions (``rollout``, ``loss_fn``, ...),
    from the closure cells of its ``train_step``."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _kw(arch):
    return dict(num_envs=E, horizon=T, epochs=EPOCHS, num_minibatches=N_MB,
                policy_arch=arch, seed=0, **FAMILIES[arch])


def _jax_noise(rng, arch, B):
    """The draws JAX's ``train_step(..., rng)`` makes, as port tensors."""
    rng_roll, rng_perm = jax.random.split(rng)
    keys = jax.random.split(rng_roll, T)
    if arch == "ga3c":
        name, draw = "gumbel", lambda k: jax.random.gumbel(k, (11,), jnp.float32)
    else:
        name, draw = "eps", lambda k: jax.random.normal(k, (2,), jnp.float32)
    ids = jnp.arange(B)
    noise = jax.vmap(lambda kt: jax.vmap(lambda i: draw(jax.random.fold_in(kt, i)))(ids))(keys)
    perm = jnp.stack([jax.random.permutation(k, B) for k in jax.random.split(rng_perm, EPOCHS)])
    return {name: torch.tensor(np.asarray(noise)), "perm": torch.tensor(np.asarray(perm)).long()}


class _Family:
    """One family's JAX run (float32, x64 off) and the port's trainer."""

    def __init__(self, arch):
        self.arch = arch
        cfg = DRL_CFG if arch == "drl_long" else None
        with jax.enable_x64(False):
            jts, jinit, self.obs_dim = jppo.make_ppo(jppo.PPOConfig(**_kw(arch)),
                                                     cfg=cfg and JCfg(**cfg))
            self.jc = _closure(jts)
            self.jc.update(_closure(self.jc["loss_fn"]))      # net_apply, dist_logp, ...
            carry = jinit(jax.random.PRNGKey(0))
            B = self.jc["B"]
            rngs = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
            self.noise = [_jax_noise(r, arch, B) for r in rngs]
            step = jax.jit(jts)
            out1 = step(*carry, rngs[0])
            out2 = step(*out1[:5], rngs[1])
            roll = jax.jit(self.jc["rollout"])(*carry[0:1], *carry[2:5],
                                               jax.random.split(rngs[0])[0])
            self.carry0, self.out1, self.out2 = _np(carry), _np(out1), _np(out2)
            self.roll = _np(roll[3])
            self.gae = _np(jppo.compute_gae(roll[3]["reward"], roll[3]["value"],
                                            roll[3]["done"], roll[3]["last_value"], 0.99, 0.95))
        self.trainer = tppo.PPOTrainer(tppo.PPOConfig(**_kw(arch)), cfg=cfg and TCfg(**cfg),
                                       device="cpu")

    def port_carry(self, carry, fresh_opt=False):
        """The port's ``(params, opt_state, states, counters, obs)`` from a
        JAX carry of numpy arrays."""
        params = convert.ppo_params_from_numpy(self.arch, carry[0], device="cpu")
        opt = (optim.init(tppo.trainable_params(params)) if fresh_opt
               else convert.adam_state_from_numpy(self.arch, carry[1], params))
        return (params, opt, tp.to_torch(carry[2]),
                torch.tensor(carry[3]), {k: torch.tensor(v) for k, v in carry[4].items()})


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    return _Family(request.param)


def _close_scaled(got, want, rel, what, rtol=0.0):
    """``|got - want| <= rel * max|want| + rtol * |want|``."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel * float(np.abs(want).max(initial=0.0)), err_msg=what)


def _jax_layout(arch, tensors):
    """``{name: tensor}`` (parameters, gradients or Adam moments) as numpy
    arrays in the JAX package's layout (DRL-Long's dense kernels ``[in,
    out]``)."""
    out = {}
    for k, t in tensors.items():
        a = t.detach().cpu().numpy()
        out[k] = a.T if arch == "drl_long" and tdrl.is_dense_weight(k) else a
    return out


def _assert_params(arch, params, want, tol):
    got = convert.ppo_params_to_numpy(arch, params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _assert_step_outputs(fam, out, want, iteration):
    params, opt, states, counters, obs, metrics = out
    _assert_params(fam.arch, params, want[0], PARAMS_F32)
    adam = {"count": int(opt["count"]), "mu": _jax_layout(fam.arch, opt["mu"]),
            "nu": _jax_layout(fam.arch, opt["nu"])}
    jadam = want[1][1][0]       # chain(clip, chain(scale_by_adam, scale)) state
    assert int(adam["count"]) == int(jadam.count) == EPOCHS * N_MB * iteration
    for moment in ("mu", "nu"):
        for k, v in getattr(jadam, moment).items():
            _close_scaled(adam[moment][k], v, 1e-3, f"{moment}/{k}", rtol=1e-3)
    tp.assert_states_close(states, want[2], rtol=1e-5, atol=1e-5,
                           angles=("heading_ego_frame",))
    np.testing.assert_array_equal(counters.numpy(), want[3])
    tp.assert_tree_close(obs, want[4], 1e-5, 1e-5, "obs", angles=("heading_ego_frame",))
    assert sorted(metrics) == sorted(want[5])
    for k, v in want[5].items():
        np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **METRICS)


# ----------------------------------------------------------------- pieces


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compute_gae_matches_jax(dtype):
    """Seeded [T, E] rollouts whose dones cut episodes mid-rollout."""
    rng = np.random.RandomState(3)
    Tg, Eg = 17, 6
    rews, vals = rng.randn(Tg, Eg).astype(dtype), rng.randn(Tg, Eg).astype(dtype)
    dones = rng.rand(Tg, Eg) < 0.2
    last = rng.randn(Eg).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = _np(jppo.compute_gae(jnp.asarray(rews), jnp.asarray(vals), jnp.asarray(dones),
                                    jnp.asarray(last), 0.99, 0.95))
    got = tppo.compute_gae(torch.tensor(rews), torch.tensor(vals), torch.tensor(dones),
                           torch.tensor(last), 0.99, 0.95)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=1e-13, atol=1e-13)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), w, **tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_optimizer_matches_optax(dtype):
    """Three updates of ``optax.chain(clip_by_global_norm(0.5), adam(3e-4))``:
    the first two gradients' norms above 0.5 (clipped), the third below."""
    rng = np.random.RandomState(0)
    shapes = {"W": (5, 7), "b": (7,), "k": (3, 3, 2)}
    p0 = {k: rng.randn(*s).astype(dtype) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(dtype) for k, s in shapes.items()}
             for scale in (3.0, 0.5, 0.01)]
    norms = [np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in gs.values()))
             for gs in grads]
    assert norms[0] > 0.5 and norms[1] > 0.5 and norms[2] < 0.5
    with jax.enable_x64(dtype == "float64"):
        tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        js = tx.init(jp)
        want = []
        for g in grads:
            u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, u)
            want.append((_np(jp), _np(js[1][0])))
    params = {k: torch.tensor(v) for k, v in p0.items()}
    state = optim.init(params)
    for g, (wp, ws) in zip(grads, want):
        updates, state = optim.update({k: torch.tensor(v) for k, v in g.items()}, state, 0.5, 3e-4)
        optim.apply_updates(params, updates)
        assert int(state["count"]) == int(ws.count) and state["count"].dtype == torch.int32
        for k in shapes:
            for got, ref in ((params[k], wp[k]), (state["mu"][k], ws.mu[k]),
                             (state["nu"][k], ws.nu[k])):
                if dtype == "float32":
                    np.testing.assert_array_equal(got.numpy(), ref, err_msg=k)
                else:
                    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("bound", [-4.0, 0.0])
def test_clip_splits_a_tie_gradient_like_jnp_clip(bound):
    """``jnp.clip``'s gradient at a bound is 0.5; ``torch.clamp``'s is 1."""
    with jax.enable_x64(False):
        want = float(jax.grad(lambda x: jnp.clip(x, -4.0, 0.0))(jnp.float32(bound)))
    x = torch.tensor(bound, requires_grad=True)
    (g,) = torch.autograd.grad(maths.clip(x, -4.0, 0.0), x)
    assert want == float(g) == 0.5


def test_init_through_convert_gives_the_jax_forward(family):
    """JAX's initial weights through ``convert`` give JAX's forward on the
    rollout's first rows; the port's own init has JAX's names, shapes and
    dtypes."""
    fam, tr = family, family.trainer
    x = fam.roll["x"][0]
    with jax.enable_x64(False):
        want_out, want_value = _np(fam.jc["net_apply"](jax.tree.map(jnp.asarray, fam.carry0[0]),
                                                       jnp.asarray(x)))
    params = convert.ppo_params_from_numpy(fam.arch, fam.carry0[0], device="cpu")
    with torch.no_grad():
        got_out, got_value = tr.family.net_apply(params, torch.tensor(x))
    for g, w in zip(got_out + (got_value,), tuple(want_out) + (want_value,)):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(w, g.shape), **ROLL_F32)
    own = convert.ppo_params_to_numpy(fam.arch, tr.init_fn(0)[0])
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in fam.carry0[0].items()}
    assert all(p.requires_grad for p in tppo.trainable_params(tr.init_fn(1)[0]).values())


def _loss_batch(fam, dtype):
    """One fixed minibatch: the rollout's rows, stored log-probs moved off
    the current policy, seeded advantages and targets."""
    rng = np.random.RandomState(5)
    d = fam.roll
    n = d["x"].shape[0] * d["x"].shape[1]
    batch = {"x": d["x"].reshape(n, -1), "act": d["act"].reshape(n, -1),
             "logp": d["logp"].reshape(n) + 0.1 * rng.randn(n),
             "adv": rng.randn(n), "target": rng.randn(n), "alive": d["alive"].reshape(n)}
    act_dtype = np.float32 if fam.arch == "ga3c" else dtype      # GA3C's indices stay float32
    return {k: np.asarray(v, act_dtype if k == "act" else dtype) for k, v in batch.items()}


def _loss_params(fam, dtype):
    p = {k: np.array(v) for k, v in fam.carry0[0].items()}
    if "log_std" in p:
        p["log_std"] = np.array([-4.0, 0.0], np.float32)   # both bounds of the clip
    keep_f32 = ("input_avg", "input_std")
    return {k: v if k in keep_f32 else v.astype(dtype) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loss_and_gradients_match_jax(family, dtype):
    """``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    JAX trainer's own ``loss_fn``.  The Gaussian families' ``log_std`` sits
    at -4.0 and 0.0, the bounds of its clip, where the gradient is JAX's
    0.5 tie; GA3C trains ``input_avg`` and ``input_std``, whose slot 0 (the
    sequence length, read through an int cast) gets a zero gradient."""
    fam = family
    p_np, b_np = _loss_params(fam, dtype), _loss_batch(fam, dtype)
    with jax.enable_x64(dtype == "float64"):
        (jl, (jv, jf)), jg = jax.jit(jax.value_and_grad(fam.jc["loss_fn"], has_aux=True))(
            jax.tree.map(jnp.asarray, p_np), jax.tree.map(jnp.asarray, b_np))
        jl, jv, jf, jg = _np((jl, jv, jf, jg))
    params = convert.ppo_params_from_numpy(fam.arch, p_np, device="cpu")
    loss, (v_loss, frac) = fam.trainer.loss_fn(params, {k: torch.tensor(v)
                                                        for k, v in b_np.items()})
    named = tppo.trainable_params(params)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    rtol, rel = (1e-5, 1e-5) if dtype == "float32" else (1e-12, 1e-10)
    for g, w in ((loss, jl), (v_loss, jv), (frac, jf)):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=rtol)
    port_g = _jax_layout(fam.arch, grads)
    assert sorted(port_g) == sorted(jg)
    for k, w in jg.items():
        assert port_g[k].dtype == w.dtype, k
        _close_scaled(port_g[k], w, rel, k)
    if fam.arch == "ga3c":
        for k in ("input_avg", "input_std"):
            assert port_g[k][0] == 0.0 and jg[k][0] == 0.0
            assert np.abs(port_g[k][1:5]).min() > 0.0, k
    else:
        assert np.abs(port_g["log_std"]).min() > 0.0


# -------------------------------------------------------------- train step


def test_rollout_and_gae_match_jax(family):
    fam, tr = family, family.trainer
    carry = fam.port_carry(fam.carry0, fresh_opt=True)
    *_, data = tr.rollout(carry[0], *carry[2:5], fam.noise[0])
    want = fam.roll
    for k in ("done", "game_over", "alive"):
        np.testing.assert_array_equal(data[k].numpy(), want[k], err_msg=k)
    if fam.arch == "ga3c":
        np.testing.assert_array_equal(data["act"].numpy(), want["act"])
    for k in ("x", "act", "logp", "value", "reward", "raw_reward", "last_value"):
        assert data[k].dtype == torch.float32, k
        np.testing.assert_allclose(data[k].numpy(), want[k], err_msg=k, **ROLL_F32)
    adv, target = tppo.compute_gae(data["reward"], data["value"], data["done"],
                                   data["last_value"], 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), fam.gae[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(target.numpy(), fam.gae[1], rtol=1e-5, atol=1e-5)


def test_train_step_matches_jax(family):
    """One whole iteration from JAX's initial carry, with fresh Adam state."""
    fam = family
    out = fam.trainer.train_step(*fam.port_carry(fam.carry0, fresh_opt=True),
                                 noise=fam.noise[0])
    _assert_step_outputs(fam, out, fam.out1, 1)
    if fam.arch == "ga3c":          # Adam leaves the zero-gradient slot 0 in place
        assert float(out[0].input_avg[0].detach()) == 0.0
        assert float(out[0].input_std[0].detach()) == 1.0


def test_second_train_step_with_adam_moments_matches_jax(family):
    """The next iteration from JAX's carry after the first, its optimizer
    state (non-zero moments, count 4) through ``adam_state_from_numpy``."""
    fam = family
    carry = fam.port_carry(fam.out1[:5])
    assert int(carry[1]["count"]) == EPOCHS * N_MB
    out = fam.trainer.train_step(*carry, noise=fam.noise[1])
    _assert_step_outputs(fam, out, fam.out2, 2)


# -------------------------------------------------------- resume, CLI


def _small_trainer():
    ppo = tppo.PPOConfig(num_envs=4, horizon=4, num_agents=2, epochs=2, num_minibatches=2,
                         seed=5)
    return tppo.PPOTrainer(ppo, device="cpu")


def test_checkpoint_resume_is_bitwise(tmp_path):
    """Two iterations straight equal one, save, load, one more (the
    counterpart of ``tests/test_ppo.py::test_ppo_checkpoint_resume_is_bitwise``);
    the generator's state is part of the saved carry."""
    tr = _small_trainer()

    def advance(carry, gen, n):
        for _ in range(n):
            *carry, _m = tr.train_step(*carry, rng=gen)
        return tuple(carry)

    gen = torch.Generator().manual_seed(9)
    straight = advance(tr.init_fn(5), gen, 2) + (gen,)
    gen = torch.Generator().manual_seed(9)
    half = advance(tr.init_fn(5), gen, 1) + (gen,)
    path = str(tmp_path / "carry.npz")
    ckpt.save_state(path, half)
    *carry, gen = ckpt.load_state(path, half)
    resumed = advance(carry, gen, 1) + (gen,)
    got, got_record = ckpt.structure(resumed)
    want, want_record = ckpt.structure(straight)
    assert got_record == want_record
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    other = (tppo.ActorCritic({k: np.zeros((1,), np.float32)
                               for k in tppo.ActorCritic.NAMES}),) + half[1:]
    with pytest.raises(ValueError, match="another structure"):
        ckpt.load_state(path, other)


def _cli():
    spec = importlib.util.spec_from_file_location(
        "train_ppo_torch", os.path.join(REPO, "scripts", "train_ppo_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_agents_mix_rejects_empty_segments(capsys):
    cli = _cli()
    assert cli.build_parser().parse_args(["--agents-mix", "3, 4"]).agents_mix == [3, 4]
    for bad in ("3,,4", "3,", "3,x"):
        with pytest.raises(SystemExit) as err:
            cli.build_parser().parse_args(["--agents-mix", bad])
        assert err.value.code == 2
        assert "--agents-mix" in capsys.readouterr().err


def test_cli_trains_on_the_cpu_and_exports_a_net_jax_loads(tmp_path):
    """``--device cpu --iters 1`` of the GA3C self-play recipe at a toy
    size; the exported ``.npz`` loads in the JAX package's
    ``models.ga3c_cadrl.load_params`` and gives the port's forward."""
    export = str(tmp_path / "net.npz")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "train_ppo_torch.py"), "--device", "cpu",
         "--iters", "1", "--envs", "4", "--horizon", "4", "--agents", "2", "--pool-cases", "8",
         "--arch", "ga3c", "--self-play", "--shaping", "0.1", "--export-params", export],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("obs_dim=26 envs=4 horizon=4 agents=2") and "device=cpu" in lines[0]
    assert lines[1].startswith("iter    0  return/ep ") and "env-steps/s" in lines[1]
    with jax.enable_x64(False):
        jnet = jga3c.load_params(export)
        x = np.random.RandomState(1).uniform(-1, 1, (16, 26)).astype(np.float32)
        x[:, 0] = np.arange(16) % 4
        want = _np(jga3c.forward(jnet, jnp.asarray(x)))
    with np.load(export) as z:
        net = tga3c.GA3CCADRL({k: z[k] for k in z.files})
    got = tga3c.forward(net, torch.tensor(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5, atol=1e-6)
