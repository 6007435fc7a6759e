"""The port's REINFORCE example (``scripts/train_example_torch.py``) against
the JAX package's (``scripts/train_example.py``) on the CPU.

Both runs start from JAX's draws: ``init_policy(PRNGKey(seed))`` and every
iteration's ``eps``, rebuilt here from the keys as JAX's ``run`` splits them
and handed to the port (``init=``, ``noise=``); JAX runs with x64 off, as
the script does.  At E = 16, T = 8, two agents, seed 1 (the JAX test's
two-agent size):

* the mean returns within atol 1e-6 (readings: at most 1.2e-7);
* after one iteration, every parameter whose gradient is 0 or at least
  1e-6 (all but 10 of W1's 1728 entries, 1 of b1's 64 and 2 of W2's 256)
  within atol 1e-6
  (1.0e-7); the others within the learning rate: Adam's
  first step is ``lr * g / (|g| + 1e-8)``, so an entry whose gradient is
  near Adam's epsilon (6e-10 to 1e-9 here, a hidden unit active on a few
  samples) moves by a share of ``lr`` that ulps of ``g`` decide (2.7e-4);
* after two iterations, every parameter within atol 1e-3, a third of the
  learning rate (3.0e-4): the second step's moment ratio carries those
  entries on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread per process)
from gym_collision_avoidance_torch.train import optim
from scripts import train_example as jx
from scripts import train_example_torch as tx

E, T, SEED, AGENTS = 16, 8, 1, 2
RET_ATOL = 1e-6
PARAM_ATOL, GRAD_FLOOR = 1e-6, 1e-6
PARAM_ATOL_2 = 1e-3


def jax_draws(seed, obs_dim, iters):
    """JAX's example's initial weights ``(W1, b1, W2, b2)`` and every
    iteration's ``eps [iters, T, E, 2]``, from ``PRNGKey(seed)`` as its
    ``run``, ``init_policy`` and rollout split it."""
    rng = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(rng)
    H = tx.HIDDEN
    W1 = jax.random.normal(k1, (obs_dim, H), jnp.float32) * (2.0 / obs_dim) ** 0.5
    W2 = jax.random.normal(k2, (H, 4), jnp.float32) * (2.0 / H) ** 0.5
    eps = []
    for _ in range(iters):
        rng, key = jax.random.split(rng)
        steps = []
        for _ in range(T):
            key, k = jax.random.split(key)
            steps.append(jax.random.normal(k, (E, 2), jnp.float32))
        eps.append(jnp.stack(steps))
    init = (np.asarray(W1), np.zeros(H, np.float32), np.asarray(W2), np.zeros(4, np.float32))
    return init, np.asarray(jnp.stack(eps))


@pytest.fixture(scope="module")
def runs():
    """JAX's run of 1 and of 2 iterations, the port's trainer and JAX's
    draws."""
    with jax.enable_x64(False):
        run = jx.build(E, T, seed=SEED, num_agents=AGENTS)
        jax_runs = {n: run(n) for n in (1, 2)}
        trainer = tx.Reinforce(E, T, seed=SEED, num_agents=AGENTS, device="cpu")
        init, noise = jax_draws(SEED, trainer.obs_dim, 2)
    return jax_runs, trainer, init, noise


def _params(p):
    return {k: v.detach().numpy() for k, v in p.items()}


def test_reinforce_one_iteration_matches_jax(runs):
    jax_runs, trainer, init, noise = runs
    want_p, want_rets = jax_runs[1]
    got_p, got_rets = trainer.run(1, init=init, noise=noise)
    np.testing.assert_allclose(got_rets, want_rets, rtol=0, atol=RET_ATOL)
    p0 = {k: torch.tensor(v).requires_grad_(True) for k, v in zip(tx.PARAM_NAMES, init)}
    *_, grads = trainer.train_step(p0, optim.init(p0), torch.tensor(noise[0]))
    got_p = _params(got_p)
    for k in tx.PARAM_NAMES:
        g = np.abs(grads[k].numpy())
        clear = (g >= GRAD_FLOOR) | (g == 0)
        assert clear.mean() > 0.95, (k, clear.mean())
        np.testing.assert_allclose(got_p[k][clear], np.asarray(want_p[k])[clear], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(got_p[k], np.asarray(want_p[k]), rtol=0, atol=tx.LR,
                                   err_msg=k)


def test_reinforce_two_iterations_match_jax(runs):
    jax_runs, trainer, init, noise = runs
    want_p, want_rets = jax_runs[2]
    got_p, got_rets = trainer.run(2, init=init, noise=noise)
    np.testing.assert_allclose(got_rets, want_rets, rtol=0, atol=RET_ATOL)
    got_p = _params(got_p)
    for k in tx.PARAM_NAMES:
        np.testing.assert_allclose(got_p[k], np.asarray(want_p[k]), rtol=0, atol=PARAM_ATOL_2,
                                   err_msg=k)


def test_case_baseline_equals_the_one_hot_products():
    """The padded row sums give the JAX example's ``((rtg @ onehot) / cnt)
    @ onehot.T``: bitwise on integer-valued float64 returns (every sum
    exact), within float32 rounding on random ones, for E a multiple of the
    case count and not."""
    rng = np.random.RandomState(0)
    for num_envs, num_cases in ((16, 2), (20, 2), (17, 2), (256, 32), (5, 1), (3, 7)):
        onehot = (np.arange(num_envs)[:, None] % num_cases
                  == np.arange(num_cases)[None]).astype(np.float64)
        cnt = np.maximum(onehot.sum(0), 1.0)
        ints = rng.randint(-50, 50, (T, num_envs)).astype(np.float64)
        want = ((ints @ onehot) / cnt) @ onehot.T
        got = tx.case_baseline(torch.tensor(ints), num_cases).numpy()
        np.testing.assert_array_equal(got, want)
        floats = rng.randn(T, num_envs).astype(np.float32)
        want = ((floats @ onehot.astype(np.float32)) / cnt.astype(np.float32)) @ onehot.T
        got = tx.case_baseline(torch.tensor(floats), num_cases).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_reinforce_single_agent_improves():
    """``tests/test_train_example.py``'s check at its size, the port's own
    draws: finite returns that trend up."""
    _p, rets = tx.build(64, 30, seed=0, num_agents=1, device="cpu")(14)
    rets = np.asarray(rets)
    assert np.isfinite(rets).all()
    assert rets[-5:].mean() > rets[:5].mean() + 0.02, rets


def test_reinforce_two_agent_float32_has_no_nan():
    run = tx.build(16, 8, seed=1, num_agents=2, device="cpu")
    p, rets = run(2, generator=torch.Generator().manual_seed(3))
    assert np.isfinite(np.asarray(rets)).all()
    assert all(torch.isfinite(v).all() for v in p.values())
