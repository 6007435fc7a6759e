"""The multi-device entry points of the port on the CPU: ``entry.py`` (the
counterpart of ``__graft_entry__.py``) and the scripts
``scaling_bench_torch.py``, ``scaling_multiproc_torch.py`` and
``collective_overhead_torch.py``, over gloo ranks.

* ``entry()``'s step against ``__graft_entry__.entry()``'s on the same batch,
  float32 with JAX's x64 off: ``game_over`` exactly, states and rewards
  within rtol 1e-5 / atol 1e-6 (float32; XLA's and torch's atan2/sin/cos
  differ by ulps), discrete leaves exactly.
* ``dryrun_multichip(2, device="cpu")`` completes, serves episodes, and its
  reduced metrics are the same on both ranks.
* The dry run's rollout (GA3C-CADRL with the weights broadcast from rank 0),
  8 envs each on its own pool case, 60 steps: 2 gloo ranks against 1 rank
  (done counts equal, mean rewards within rtol 1e-6 / atol 1e-7: a mean of
  two slice means against one mean) and against JAX's
  ``make_distributed_rollout`` on 2 devices of the conftest's virtual mesh
  (done counts equal, mean rewards within rtol 1e-5 / atol 1e-6).
* Each script at its smallest size on 1 and 2 gloo ranks reports the JAX
  script's keys; the collective accounting equals what wrapping
  ``torch.distributed.all_reduce`` records, and its parameter count equals
  JAX's ``make_ppo``'s for the same ``PPOConfig``.
* NCCL with more ranks than cards raises, and so does the card default
  without CUDA: nothing falls back to gloo or to the CPU.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import _torch_dist
import _torch_parity as tp
from gym_collision_avoidance_torch import convert, entry
from gym_collision_avoidance_torch.parallel import distributed as dist
from gym_collision_avoidance_torch.parallel import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
REDUCED_TOL = dict(rtol=1e-6, atol=1e-7)
ROLLOUT_ENVS, ROLLOUT_STEPS = 8, 60


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script(name):
    return _load(os.path.join("scripts", f"{name}.py"), name)


def test_entry_matches_jax_graft_entry():
    """One step of 8 GA3C-CADRL envs: the port's batch is JAX's, and the
    port's step from JAX's batch is JAX's step."""
    import jax

    with jax.enable_x64(False):
        fn, (states,) = _load("__graft_entry__.py", "graft_entry").entry()
        ref_states, ref_rew, ref_go = jax.jit(fn)(states)
        init, want = tp.jax_leaves(states), tp.jax_leaves(ref_states)
        ref_rew, ref_go = np.asarray(ref_rew), np.asarray(ref_go)
    port_fn, (port_states,) = entry.entry(device="cpu")
    tp.assert_tree_close(convert.state_to_numpy(port_states), init, path="init", **TOL)
    got, rew, game_over = port_fn(convert.state_from_numpy(init, device="cpu"))
    np.testing.assert_array_equal(game_over.numpy(), ref_go)
    np.testing.assert_allclose(rew.numpy(), ref_rew, **TOL)
    tp.assert_tree_close(convert.state_to_numpy(got), want, path="state", **TOL)
    assert rew.shape == (8, 4) and bool((got.speed > 0).all())


@pytest.fixture(scope="module")
def dryrun2():
    return entry.dryrun_multichip(2, device="cpu")


def test_dryrun_multichip_two_cpu_ranks(dryrun2):
    assert [(r["rank"], r["size"], r["backend"], r["device"]) for r in dryrun2] == \
        [(0, 2, "gloo", "cpu"), (1, 2, "gloo", "cpu")]
    assert dryrun2[0]["episodes"] == dryrun2[1]["episodes"] > 0
    for key in ("step_metrics", "rollout", "serving_mean_reward"):
        assert dryrun2[0][key] == dryrun2[1][key], key
    # the trainer's four reward and episode metrics are means over the ranks
    for key in ("mean_step_reward", "mean_shaped_reward", "episodes_finished"):
        assert dryrun2[0]["ppo"][key] == dryrun2[1]["ppo"][key], key
    assert all(np.isfinite(v) for v in dryrun2[0]["ppo"].values())
    # the wrappers run the plain versions on the CPU: no launch counted
    assert all(r["launches"] == {"pairwise": 0, "raymarch": 0, "laser_fused": 0,
                                 "cadrl_value": 0, "drl_long_conv": 0}
               for r in dryrun2)


def _rollout_states():
    """ROLLOUT_ENVS envs of the entry point's config, each on its own pool
    case, after a reset (numpy leaves)."""
    from gym_collision_avoidance_torch.env import autoreset
    from gym_collision_avoidance_torch.env.step import env_reset
    from gym_collision_avoidance_torch.policies import registry
    from gym_collision_avoidance_torch.scenarios import random_cases

    cfg, _sc, _one, _params = entry.build_batch(1, device="cpu")
    pool = random_cases.scenario_pool(ROLLOUT_ENVS, 4, seed=3, side_length=4.0)
    st = autoreset.state_from_case(cfg, pool, np.full(4, registry.GA3C_CADRL, np.int32),
                                   device="cpu")
    return convert.state_to_numpy(env_reset(st, cfg)[0])


def _jax_rollout(leaves):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gym_collision_avoidance_tpu import EnvConfig
    from gym_collision_avoidance_tpu.models import ga3c_cadrl
    from gym_collision_avoidance_tpu.parallel import distributed as jdist
    from gym_collision_avoidance_tpu.policies import registry

    with jax.enable_x64(False):
        mesh = Mesh(np.array(jax.devices()[:2]), ("env",))
        cfg = EnvConfig(dtype="float32", max_num_other_agents_observed=19,
                        agent_sorting_method="closest_last")
        states = jax.device_put(tp.jax_state(leaves), NamedSharding(mesh, P("env")))
        params = jdist.replicate_global({"ga3c_cadrl": ga3c_cadrl.load_params()}, mesh)
        run = jdist.make_distributed_rollout(cfg, ROLLOUT_STEPS, mesh,
                                             active_policies=(registry.GA3C_CADRL,),
                                             with_params=True)
        _final, metrics = run(states, params)
        return {k: np.asarray(v) for k, v in metrics.items()}


def test_distributed_rollout_two_ranks_against_one_and_jax(tmp_path):
    leaves = _rollout_states()
    job = {"cases": ["entry_rollout"],
           "entry_rollout": {"states": leaves, "steps": ROLLOUT_STEPS}}
    ranks = _torch_dist.run_ranks(job, 2, str(tmp_path))
    cfg, sc, _one, params = entry.build_batch(1, device="cpu")
    run = dist.make_distributed_rollout(cfg, ROLLOUT_STEPS, pmesh.make_mesh(device_type="cpu"),
                                        sc.active_policies, with_params=True)
    final, one = run(convert.state_from_numpy(leaves, device="cpu"), params)
    one = {k: v.numpy() for k, v in one.items()}
    jax_metrics = _jax_rollout(leaves)
    assert one["done_count"].sum() > 0
    for r in ranks:
        got = {k: v.numpy() for k, v in r["entry_rollout"]["metrics"].items()}
        np.testing.assert_array_equal(got["done_count"], one["done_count"])
        np.testing.assert_allclose(got["mean_reward"], one["mean_reward"], **REDUCED_TOL)
        np.testing.assert_array_equal(got["done_count"], jax_metrics["done_count"])
        np.testing.assert_allclose(got["mean_reward"], jax_metrics["mean_reward"], **TOL)
    # the ranks' final slices are the unsharded run's rows
    joined = {k: np.concatenate([r["entry_rollout"]["states"][k] for r in ranks])
              for k in leaves}
    tp.assert_tree_close(joined, convert.state_to_numpy(final), 0, 0, "state")


def _run_script(name, argv):
    """``run(parse_args(argv))`` of ``scripts/<name>.py`` and its printed
    JSON lines."""
    module = _script(name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.run(module.parse_args(argv))
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    return result, lines


def test_scaling_bench_keys_on_one_and_two_ranks(tmp_path):
    out = tmp_path / "scaling.md"
    result, lines = _run_script("scaling_bench_torch", [
        "--device", "cpu", "--max-ranks", "2", "--envs-per-device", "2", "--steps", "2",
        "--reps", "1", "--out", str(out)])
    keys = {"rollout_weak": {"agent_steps_per_s", "per_device", "efficiency", "vs_1dev"},
            "rollout_fixed": {"agent_steps_per_s", "vs_1dev"},
            "serving_weak": {"env_steps_per_s", "episodes", "vs_1dev", "efficiency"},
            "serving_fixed": {"env_steps_per_s", "episodes", "vs_1dev"},
            "ppo": {"train_env_steps_per_s", "vs_1dev"}}
    assert sorted(result["tables"]) == sorted(keys)
    for name, want in keys.items():
        rows = result["tables"][name]
        assert [r["ranks"] for r in rows] == [1, 2], name
        assert all(want | {"ranks", "envs"} <= set(r) for r in rows), (name, rows)
        assert rows[0]["vs_1dev"] == 1.0
        assert [x for x in lines if x["table"] == name] == [{"table": name, **r} for r in rows]
    assert [r["envs"] for r in result["tables"]["rollout_weak"]] == [2, 4]
    assert [r["envs"] for r in result["tables"]["serving_fixed"]] == [4, 4]
    assert sorted(result["launches_by_rank"]) == [1, 2]
    assert [len(v) for v in result["launches_by_rank"].values()] == [1, 2]
    text = out.read_text()
    for heading in ("# Weak-scaling measurement", "## Sharding overhead",
                    "## Sharded serving loop", "## DP-PPO training step"):
        assert heading in text
    assert "gloo, up to 2 ranks on the CPU" in text and "not scaling" not in text


def test_scaling_multiproc_keys_and_checksums():
    result, lines = _run_script("scaling_multiproc_torch", [
        "--device", "cpu", "--ranks", "2", "--envs", "8", "--steps", "4", "--reps", "1"])
    assert lines[-1] == result
    assert {"fixed_2xgloo", "weak_1xgloo", "weak_2xgloo"} <= set(result)
    for key in ("fixed_2xgloo", "weak_1xgloo", "weak_2xgloo"):
        assert {"agent_steps_per_s", "efficiency", "checksum", "launches_by_rank"} <= \
            set(result[key])
    assert result["fixed_checksums_identical"] is True
    assert [len(result[k]["launches_by_rank"]) for k in ("weak_1xgloo", "weak_2xgloo")] == [1, 2]
    assert result["weak_1xgloo"]["efficiency"] == 1.0 and result["device"] == "cpu"


@pytest.mark.parametrize("ranks", [1, 2])
def test_collective_overhead_keys(ranks, tmp_path):
    out = tmp_path / "collectives.md"
    result, lines = _run_script("collective_overhead_torch", [
        "--device", "cpu", "--ranks", str(ranks), "--ppo-envs", "8", "--envs", "16",
        "--steps", "4", "--calls", "4", "--reps", "1", "--append", str(out)])
    assert lines[0] == {"traffic": result["traffic"]}
    assert result["recorded"] == {
        "all_reduces_per_train_step": result["traffic"]["all_reduces_per_train_step"],
        "bytes_per_train_step": result["traffic"]["bytes_per_train_step"]}
    assert [c["payload"] for c in result["chains"]] == ["gradient-sized buffer", "one float32"]
    assert result["chains"][0]["bytes"] == result["traffic"]["grad_bytes"]
    assert [p["variant"] for p in result["ppo"]] == [
        "with all-reduces", "all-reduces left out (timing-only)"]
    assert result["ppo"][1]["recorded_all_reduces"] == 0
    assert [p["ranks"] for p in result["projection"]] == [2, 4, 8]
    assert all(0 < p["ppo_projected_efficiency"] <= 1 for p in result["projection"])
    assert result["one_rank"]["ppo_step_s"] > 0 and result["one_rank"]["serving_step_s"] > 0
    text = out.read_text()
    assert "## Measured collective overhead" in text and "published, not measured here" in text


def test_collective_accounting_equals_recorded_all_reduces(tmp_path):
    """The script's traffic for a 2-rank PPO iteration, a serving dispatch
    and a rollout dispatch against the all-reduces recorded on 2 gloo ranks;
    its parameter count against JAX's ``make_ppo`` for the same config."""
    import jax

    from gym_collision_avoidance_tpu.train import PPOConfig as JPPOConfig
    from gym_collision_avoidance_tpu.train import make_ppo as jmake_ppo
    from gym_collision_avoidance_torch.train import PPOConfig

    co = _script("collective_overhead_torch")
    ppo_kw = dict(num_envs=8, horizon=4, num_agents=4, epochs=2, num_minibatches=2)
    A, S, E = 4, 6, 8
    tr = co.traffic(PPOConfig(**ppo_kw), A, S, E)
    ranks = _torch_dist.run_ranks({"cases": ["count_all_reduce"], "count_all_reduce": {
        "ppo": ppo_kw, "num_agents": A, "steps": S, "envs": E}}, 2, str(tmp_path))
    for r in ranks:
        got = r["count_all_reduce"]
        assert got["ppo"] == {"calls": tr["all_reduces_per_train_step"],
                              "bytes": tr["bytes_per_train_step"]}
        assert got["serving_dispatch"] == {"calls": tr["serving_all_reduces_per_dispatch"],
                                           "bytes": tr["serving_bytes_per_dispatch"]}
        assert got["episodes_completed"] == {"calls": 1,
                                             "bytes": tr["episodes_completed_bytes_per_call"]}
        assert got["rollout_dispatch"] == {"calls": tr["rollout_all_reduces_per_dispatch"],
                                           "bytes": tr["rollout_bytes_per_step"] * S}
    with jax.enable_x64(False):
        _step, init_fn, _ = jmake_ppo(JPPOConfig(**ppo_kw))
        jparams = init_fn(jax.random.PRNGKey(0))[0]
        jax_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert tr["param_count"] == jax_count
    assert tr["grad_bytes"] == 4 * jax_count


@pytest.fixture
def one_card(monkeypatch):
    """A machine that says it has one CUDA card (nothing reaches it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_nccl_with_more_ranks_than_cards_raises(one_card):
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        entry.dryrun_multichip(2, backend="nccl")
    for name, argv in (("scaling_bench_torch", ["--max-ranks", "2"]),
                       ("collective_overhead_torch", ["--ranks", "2"])):
        module = _script(name)
        with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
            module.run(module.parse_args(argv))
    assert dist.choose_backend("cuda", 1) == "nccl"
    assert dist.choose_backend("cuda", 2, "gloo") == "gloo"
    with pytest.raises(ValueError, match="NCCL runs on CUDA cards only"):
        dist.choose_backend("cpu", 1, "nccl")
    assert dist.choose_backend("cpu", 4) == "gloo"


def test_card_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    for call in (entry.entry, lambda: entry.dryrun_multichip(1),
                 lambda: entry.build_batch(2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
