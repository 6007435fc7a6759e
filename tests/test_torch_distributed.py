"""The port's multi-process runtime and data-parallel PPO on gloo CPU ranks.

``make_sharded_ppo`` runs on ranks spawned by ``tests/_torch_dist.py``, each
with a ``PPOTrainer`` on its slice of the envs, one epoch of one minibatch
(with more, the shuffle is shard-local by design, as in the JAX package):

* against the port's unsharded ``make_ppo`` from the same carry and seed, at
  D = 4 (mlp, E = 32, T = 6, 2 agents) and D = 2 (drl_long, E = 16, T = 8,
  128 beams): the init carry, the noise and the mlp's env states bitwise
  (DRL-Long's within rtol 1e-5 / atol 2e-6: its CNN's CPU kernels round a
  batch of 8 rows differently from one of 16), counters equal; params
  within atol 1e-7 (mlp; largest reading 1.5e-8) and 1e-5 (drl_long; 2.6e-6),
  where the JAX package's ``tests/test_ppo.py`` allows rtol 2e-4 / atol
  2e-5 (and atol 7e-4 on DRL-Long's ``log_std``, which reads 0 here); and
  the gradients that the step applied, averaged over the ranks, against the
  unsharded trainer's gradient of the ranks' mean loss (each rank's
  alive-weighted means over its own samples, as in the JAX package) within
  1e-5 (mlp; reading 1.1e-6) and 3e-5 (drl_long; 9.0e-6) of each tensor's
  largest entry.  Against the plain unsharded gradient DRL-Long's
  ``log_std`` gradient differs by 29% of its largest entry, since its
  shards hold unequal alive counts;
* against the JAX package's ``make_sharded_ppo`` on 4 of the 8 virtual CPU
  devices (x64 off, its draws handed to the port as
  ``tests/test_torch_ppo.py`` does): params within atol 2e-5 (4.8e-6), env
  states within rtol/atol 1e-5 (XLA's and torch's atan2 differ by ulps),
  counters equal, metrics within rtol 1e-5 / atol 1e-6.  This shows that
  the port shuffles each shard as JAX does and averages where JAX
  ``pmean``-s.

Also: ``init_distributed``, ``process_env_slice``, the launcher
``scripts/launch_multihost_torch.py --spawn 2`` against an in-process run,
the training CLI's ``--devices 2``, and its ``--save``/``--resume`` there:
two iterations equal one, a save, a resume and one more, bitwise in every
leaf of the saved carry and generator, and a file saved at 2 ranks loads at
1 with the same global carry (``parallel.distributed.save_sharded_state``
and ``load_sharded_state``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_dist
import _torch_parity as tp
from gym_collision_avoidance_torch import EnvConfig, convert
from gym_collision_avoidance_torch.env.step import env_reset
from gym_collision_avoidance_torch.parallel import distributed as dist
from gym_collision_avoidance_torch.parallel import mesh as pmesh
from gym_collision_avoidance_torch.scenarios import presets
from gym_collision_avoidance_torch.train import ppo as tppo
from gym_collision_avoidance_tpu.train import ppo as jppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cpu"
# params after one update, by reference and family (the readings are in
# the module docstring)
PARAMS_ATOL = {("port", "mlp"): 1e-7, ("port", "drl_long"): 1e-5, ("jax", "mlp"): 2e-5}
MLP = dict(num_envs=32, horizon=6, num_agents=2, epochs=1, num_minibatches=1, lr=1e-3,
           seed=3, policy_arch="mlp")
DRL_CFG = dict(dtype="float32", done_mode="learning", reward_time_step=-0.01,
               laserscan_length=128, use_static_map=True)
DRL = dict(num_envs=16, horizon=8, num_agents=2, epochs=1, num_minibatches=1, seed=3,
           policy_arch="drl_long")
RNG = 42
# the applied gradients, within these fractions of each tensor's largest
# entry (readings in the module docstring)
GRADS_RTOL = {"mlp": 1e-5, "drl_long": 3e-5}


def _port_job(ppo_kw, cfg_kw, num_ranks):
    """The port's unsharded run of ``ppo_kw`` (init carry, one train_step
    with a generator seeded RNG), the gradients of the same step with
    ``num_ranks`` ranks' loss (:func:`_torch_dist.shard_mean_loss`), and the
    job that asks the ranks for the same."""
    cfg = EnvConfig(**cfg_kw) if cfg_kw else None
    trainer = tppo.PPOTrainer(tppo.PPOConfig(**ppo_kw), cfg=cfg, device=DEVICE)
    params, opt, states, counters, obs = trainer.init_fn(ppo_kw["seed"])
    ranks_loss = _torch_dist.shard_mean_loss(
        tppo.PPOTrainer(tppo.PPOConfig(**ppo_kw), cfg=cfg, device=DEVICE),
        trainer.sample_noise(torch.Generator().manual_seed(RNG))["perm"][0], num_ranks)
    grads = _torch_dist.record_grads(ranks_loss)
    ranks_loss.train_step(*ranks_loss.init_fn(ppo_kw["seed"]),
                          rng=torch.Generator().manual_seed(RNG))
    arch = ppo_kw["policy_arch"]
    job = {"ppo": ppo_kw, "cfg": cfg_kw, "rng": RNG,
           "params": convert.ppo_params_to_numpy(arch, params),
           "states": convert.state_to_numpy(states), "counters": counters.clone(),
           "obs": {k: v.clone() for k, v in obs.items()}}
    init = {k: job[k] for k in ("params", "states", "counters", "obs")}
    noise = trainer.sample_noise(torch.Generator().manual_seed(RNG))
    out = trainer.train_step(params, opt, states, counters, obs,
                             rng=torch.Generator().manual_seed(RNG))
    want = {"init": init, "noise": noise, "grads": grads, "params": convert.ppo_params_to_numpy(arch, out[0]),
            "states": convert.state_to_numpy(out[2]), "counters": out[3].numpy(),
            "metrics": {k: float(v) for k, v in out[5].items()}}
    return job, want


def _jax_job():
    """JAX's ``make_sharded_ppo`` on 4 virtual devices (x64 off) from its
    unsharded init carry, and the job that hands the ranks the same carry
    and JAX's draws: the noise of every global stream (``fold_in(key_t,
    id)``) and the one permutation of ``B / 4`` streams that every shard
    draws (``permutation(key_epoch, B_local)``)."""
    D, B = 4, MLP["num_envs"]
    with jax.enable_x64(False):
        ppo = jppo.PPOConfig(**MLP)
        _, jinit, _ = jppo.make_ppo(ppo)
        step, _, _ = jppo.make_sharded_ppo(ppo, Mesh(np.array(jax.devices()[:D]), ("env",)))
        carry = jinit(jax.random.PRNGKey(MLP["seed"]))
        rng = jax.random.PRNGKey(RNG)
        out = jax.device_get(step(*carry, rng))
        rng_roll, rng_perm = jax.random.split(rng)
        keys = jax.random.split(rng_roll, MLP["horizon"])
        ids = jnp.arange(B)
        eps = jax.vmap(lambda kt: jax.vmap(lambda i: jax.random.normal(
            jax.random.fold_in(kt, i), (2,), jnp.float32))(ids))(keys)
        perm = jnp.stack([jax.random.permutation(k, B // D)
                          for k in jax.random.split(rng_perm, MLP["epochs"])])
        carry = jax.device_get(carry)
    job = {"ppo": MLP, "cfg": None,
           "params": {k: np.asarray(v) for k, v in carry[0].items()},
           "states": tp.jax_leaves(carry[2]), "counters": np.asarray(carry[3]),
           "obs": {k: np.asarray(v) for k, v in carry[4].items()},
           "noise": {"eps": torch.tensor(np.asarray(eps)),
                     "perm": torch.tensor(np.asarray(perm)).long()}}
    return job, out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    job4, want4 = _port_job(MLP, None, 4)
    jax_job, jax_out = _jax_job()
    job2, want2 = _port_job(DRL, DRL_CFG, 2)
    return {
        4: _torch_dist.run_ranks({"cases": ["ppo_port", "ppo_jax"], "ppo_port": job4,
                                  "ppo_jax": jax_job}, 4, tmp),
        2: _torch_dist.run_ranks({"cases": ["ppo_drl", "slice"], "ppo_drl": job2,
                                  "slice": [13, 32]}, 2, tmp),
        "want4": want4, "want2": want2, "jax_out": jax_out}


def _joined(results, case, key, within=None):
    """The ranks' ``key`` results of ``case`` (of its ``within`` part),
    joined along the env axis."""
    parts = [(r[case][within] if within else r[case])[key] for r in results]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([np.asarray(p[k]) for p in parts]) for k in parts[0]}
    return np.concatenate([np.asarray(p) for p in parts])


def _assert_equal_leaves(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what}/{k}")


def _assert_params(got, want, reference, arch):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, err_msg=k,
                                   atol=PARAMS_ATOL[reference, arch])


def _assert_grads(results, want, arch):
    """The gradients each rank applied, averaged over the ranks, against the
    unsharded trainer's gradient of the ranks' mean loss on the same
    minibatch (:func:`_torch_dist.shard_mean_loss`).  Adam's first step is
    about ``lr * sign(g)``, so the params cannot show a gradient's scale (a
    sum where the mean belongs, or a wrong divisor); this can."""
    for r in results:
        got = r[f"ppo_{'port' if arch == 'mlp' else 'drl'}"]["grads"]
        assert len(got) == len(want) == 1
        for k, g in want[0].items():
            np.testing.assert_allclose(got[0][k], g, rtol=0, err_msg=k,
                                       atol=GRADS_RTOL[arch] * np.max(np.abs(g)))


def _assert_replicas_agree(results, case):
    """Every rank ends with the same params bit for bit (the averaged
    gradients are the same everywhere), and the same reduced metrics."""
    first = results[0][case]
    for r in results[1:]:
        _assert_equal_leaves(r[case]["params"], first["params"], f"rank {r['rank']} params")
        for k in ("mean_step_reward", "mean_shaped_reward", "episodes_finished",
                  "mean_return_per_episode"):
            assert r[case]["metrics"][k] == first["metrics"][k], k


@pytest.mark.parametrize("num_ranks,case,arch", [(4, "ppo_port", "mlp"),
                                                  (2, "ppo_drl", "drl_long")])
def test_sharded_ppo_matches_unsharded_port(ranks, num_ranks, case, arch):
    results, want = ranks[num_ranks], ranks[f"want{num_ranks}"]
    B = want["noise"]["perm"].shape[1]
    for r in results:
        got = r[case]
        # rank 0's params everywhere; the noise is the unsharded draw, and
        # the shard-local permutation is the order of 0 .. B/D - 1 in it
        _assert_equal_leaves(got["init"]["params"], want["init"]["params"], "init params")
        assert torch.equal(got["noise"]["eps"], want["noise"]["eps"])
        perm = want["noise"]["perm"][0]
        assert torch.equal(got["noise"]["perm"][0], perm[perm < B // num_ranks])
    _assert_equal_leaves(_joined(results, case, "states", "init"), want["init"]["states"],
                         "init states")
    _assert_equal_leaves(_joined(results, case, "obs", "init"), want["init"]["obs"],
                         "init obs")
    np.testing.assert_array_equal(_joined(results, case, "counters", "init"),
                                  want["init"]["counters"].numpy())
    if arch == "drl_long":
        # the CNN's CPU kernels round some outputs of 8 rows differently than
        # of 16 (by up to 3e-8 here), and an action an ulp apart moves a
        # state: held within the rollout tolerance of tests/test_torch_ppo.py
        tp.assert_tree_close(_joined(results, case, "states"), want["states"], 1e-5, 2e-6,
                             "states", angles=("heading_ego_frame",))
    else:
        _assert_equal_leaves(_joined(results, case, "states"), want["states"], "states")
    np.testing.assert_array_equal(_joined(results, case, "counters"), want["counters"])
    _assert_params(results[0][case]["params"], want["params"], "port", arch)
    _assert_replicas_agree(results, case)
    _assert_grads(results, want["grads"], arch)
    for k in ("mean_step_reward", "mean_shaped_reward", "mean_return_per_episode"):
        np.testing.assert_allclose(results[0][case]["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_sharded_ppo_matches_jax_sharded_ppo(ranks):
    results, out = ranks[4], ranks["jax_out"]
    _assert_params(results[0]["ppo_jax"]["params"], out[0], "jax", "mlp")
    _assert_replicas_agree(results, "ppo_jax")
    got = {k: _joined(results, "ppo_jax", "states")[k] for k in tp.jax_leaves(out[2])}
    tp.assert_tree_close(got, tp.jax_leaves(out[2]), 1e-5, 1e-5, "state",
                         angles=("heading_ego_frame",))
    np.testing.assert_array_equal(_joined(results, "ppo_jax", "counters"), np.asarray(out[3]))
    for k, v in out[5].items():
        np.testing.assert_allclose(results[0]["ppo_jax"]["metrics"][k], float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_init_distributed_and_env_slices(ranks, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert dist.init_distributed() is False
    with pytest.raises(ValueError, match="backend"):
        dist.init_distributed(init_method="file:///nonexistent/rendezvous")
    mesh = pmesh.make_mesh(device_type="cpu")
    assert dist.process_env_slice(32, mesh) == (0, 32)
    for r in ranks[2]:
        assert r["slice"][32] == (16 * r["rank"], 16)
        assert "must divide the 2-rank mesh" in r["slice"][13]


def test_launcher_spawn_matches_in_process_run():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        "launch_multihost_torch.py"),
                           "--spawn", "2", "--device", "cpu", "--num-envs", "32",
                           "--steps", "48"],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])
    assert (result["num_processes"], result["backend"]) == (2, "gloo")

    cfg = EnvConfig.evaluate(dtype="float32")
    sc = presets.circle_scenario(4, radius=4.0, agent_radius=0.4)
    base, _ = env_reset(sc.to_state(cfg, device=DEVICE), cfg)
    states = base.map(lambda x: x.repeat((32,) + (1,) * (x.dim() - 1)))
    run = dist.make_distributed_rollout(cfg, 48, pmesh.make_mesh(device_type="cpu"),
                                        sc.active_policies)
    _, metrics = run(states)
    assert result["metrics_checksum"] == pytest.approx(float(metrics["mean_reward"].sum()),
                                                       abs=1e-6)
    assert result["done_count"] == float(metrics["done_count"].sum()) > 0


def test_training_cli_trains_on_two_cpu_ranks():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "train_ppo_torch.py"),
                           "--device", "cpu", "--devices", "2", "--iters", "1", "--envs", "8",
                           "--horizon", "4", "--pool-cases", "8"],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("total:") == 1 and "devices=2" in proc.stdout


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The training CLI's files (2 agents, 8 envs, horizon 4): ``two`` after
    2 iterations on 2 gloo ranks; ``one`` after 1; ``resumed`` after
    resuming ``one`` for 1 more; ``single`` after loading ``two`` on 1 rank
    and running none."""
    tmp = tmp_path_factory.mktemp("resume")
    files = {k: str(tmp / f"{k}.npz") for k in ("two", "one", "resumed", "single")}
    runs = ((2, 2, None, "two"), (2, 1, None, "one"), (2, 1, "one", "resumed"),
            (1, 0, "two", "single"))
    for devices, iters, resume, save in runs:
        cmd = [sys.executable, os.path.join(REPO, "scripts", "train_ppo_torch.py"),
               "--device", "cpu", "--devices", str(devices), "--iters", str(iters),
               "--envs", "8", "--horizon", "4", "--pool-cases", "8", "--save", files[save]]
        if resume:
            cmd += ["--resume", files[resume]]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.count(f"saved {files[save]}") == 1
    return {k: dict(np.load(v)) for k, v in files.items()}


def _assert_same_file(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_training_cli_resumes_two_ranks_bitwise(saved):
    _assert_same_file(saved["resumed"], saved["two"])
    assert any(not np.array_equal(saved["one"][k], saved["two"][k]) for k in saved["two"])


def test_training_cli_loads_a_two_rank_file_on_one(saved):
    _assert_same_file(saved["single"], saved["two"])
