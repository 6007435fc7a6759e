"""The port's env-axis mesh on gloo CPU ranks against the unsharded port.

Each sharded case runs on 2 or 4 ranks spawned by ``tests/_torch_dist.py``
(one process and one intra-op thread each), each rank stepping its own
contiguous slice of the envs; the unsharded run is this process's.  States,
counters and episode counts must be bitwise equal: the physics of an env
does not depend on where it runs.  The metrics that sum over envs are held
to rtol 1e-6 (the JAX package's ``tests/test_parallel.py`` limit): the ranks
sum their slices and the all-reduce sums the ranks, in another order than
one sum.  Also: ``utils/profiling.py``.
"""

import glob

import numpy as np
import pytest
import torch

import _torch_dist
from gym_collision_avoidance_torch import EnvConfig, convert, env_step
from gym_collision_avoidance_torch.env import autoreset
from gym_collision_avoidance_torch.env.step import env_reset
from gym_collision_avoidance_torch.harness.serving import AutoresetServer
from gym_collision_avoidance_torch.models import ga3c_cadrl
from gym_collision_avoidance_torch.parallel import distributed as dist
from gym_collision_avoidance_torch.parallel import mesh as pmesh
from gym_collision_avoidance_torch.policies import registry
from gym_collision_avoidance_torch.scenarios import presets, random_cases
from gym_collision_avoidance_torch.utils import profiling

torch.set_num_threads(1)
DEVICE = "cpu"
SERVER = dict(cfg=dict(dtype="float32", done_mode="evaluate"),
              pool=random_cases.scenario_pool(8, 4, seed=0, side_length=4.0),
              policy_id=np.full(4, registry.NONCOOP, np.int32), num_envs=16, steps=32,
              dispatches=3)
GA3C_CFG = dict(dtype="float32", done_mode="evaluate", max_num_other_agents_observed=19,
                agent_sorting_method="closest_last")
ROLLOUT_STEPS = 24


def _pool_states(cfg, E, A, policy, seed):
    pool = random_cases.scenario_pool(E, A, seed=seed, side_length=4.0)
    st = autoreset.state_from_case(cfg, pool, np.full(A, policy, np.int32), device=DEVICE)
    return env_reset(st, cfg)[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Results of the 2-rank job (server, GA3C step, rollouts) and the
    4-rank one (server)."""
    tmp = tmp_path_factory.mktemp("parallel")
    step_states = _pool_states(EnvConfig(**GA3C_CFG), 8, 4, registry.GA3C_CADRL, 3)
    roll_cfg = dict(dtype="float32", done_mode="evaluate")
    roll_states = _pool_states(EnvConfig(**roll_cfg), 16, 4, registry.NONCOOP, 4)
    job2 = {"cases": ["server", "batched_step", "rollout"], "server": SERVER,
            "batched_step": dict(cfg=GA3C_CFG, active=(registry.GA3C_CADRL,),
                                 states=convert.state_to_numpy(step_states)),
            "rollout": dict(cfg=roll_cfg, active=(registry.NONCOOP,), steps=ROLLOUT_STEPS,
                            states=convert.state_to_numpy(roll_states))}
    return {2: _torch_dist.run_ranks(job2, 2, tmp),
            4: _torch_dist.run_ranks({"cases": ["server"], "server": SERVER}, 4, tmp),
            "step_states": step_states, "roll_states": roll_states}


def _cat(results, case, key):
    """A case's per-rank ``{leaf: array}`` (or tensor) results joined along
    the env axis."""
    parts = [r[case][key] for r in results]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([np.asarray(p[k]) for p in parts]) for k in parts[0]}
    return np.concatenate([np.asarray(p) for p in parts])


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("num_ranks", [2, 4])
def test_sharded_server_matches_unsharded(ranks, num_ranks):
    results = ranks[num_ranks]
    assert [r["size"] for r in results] == [num_ranks] * num_ranks
    plain = AutoresetServer(EnvConfig(**SERVER["cfg"]), SERVER["pool"], SERVER["policy_id"],
                            num_envs=SERVER["num_envs"], steps_per_dispatch=SERVER["steps"],
                            device=DEVICE)
    for d in range(SERVER["dispatches"]):
        want = plain.dispatch()
        for r in results:            # every rank returns the global metrics
            got = r["server"]["outs"][d]
            assert got["obs_checksum"].shape == want["obs_checksum"].shape == (32, 4)
            for k in ("obs_checksum", "mean_reward"):
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6,
                                           err_msg=k)
    assert all(r["server"]["episodes"] == plain.episodes_completed() for r in results)
    assert plain.episodes_completed() > 0
    _assert_leaves_equal(_cat(results, "server", "states"),
                         convert.state_to_numpy(plain.states()))
    np.testing.assert_array_equal(_cat(results, "server", "counters"),
                                  plain._counters.numpy())


def test_sharded_batched_step_with_ga3c_matches_unsharded(ranks):
    """GA3C-CADRL weights broadcast from rank 0; each rank steps its rows of
    8 envs with ``make_batched_step``."""
    params = {"ga3c_cadrl": ga3c_cadrl.load_params(device=DEVICE)}
    step = pmesh.make_batched_step(EnvConfig(**GA3C_CFG), (registry.GA3C_CADRL,))
    st, obs, rew, game_over, _ = step(ranks["step_states"], params)
    results = ranks[2]
    _assert_leaves_equal(_cat(results, "batched_step", "states"), convert.state_to_numpy(st))
    _assert_leaves_equal(_cat(results, "batched_step", "obs"), obs)
    np.testing.assert_array_equal(_cat(results, "batched_step", "rewards"), rew.numpy())
    np.testing.assert_array_equal(_cat(results, "batched_step", "game_over"),
                                  game_over.numpy())
    assert (st.pos != ranks["step_states"].pos).any()


def test_distributed_rollout_matches_batched_rollout(ranks):
    """``make_distributed_rollout`` on 2 ranks against the unsharded
    ``make_batched_rollout``: final states bitwise, the reduced metrics
    ``[num_steps]``, the same on every rank, with reward signal and
    finished episodes; ``make_batched_rollout(mesh=)`` reduces its metrics
    to the unsharded ones."""
    cfg = EnvConfig(dtype="float32", done_mode="evaluate")
    final, metrics = pmesh.make_batched_rollout(cfg, ROLLOUT_STEPS, (registry.NONCOOP,))(
        ranks["roll_states"])
    results = ranks[2]
    want = convert.state_to_numpy(final)
    _assert_leaves_equal(_cat(results, "rollout", "states"), want)
    _assert_leaves_equal(_cat(results, "rollout", "batched_states"), want)
    first = results[0]["rollout"]["metrics"]
    for r in results:
        got = r["rollout"]["metrics"]
        assert got["mean_reward"].shape == got["done_count"].shape == (ROLLOUT_STEPS,)
        assert torch.equal(got["mean_reward"], first["mean_reward"])
        assert torch.equal(got["done_count"], first["done_count"])
        batched = r["rollout"]["batched_metrics"]
        for k in ("mean_reward", "done_frac"):
            np.testing.assert_allclose(batched[k].numpy(), metrics[k].numpy(), rtol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(first["mean_reward"].numpy(), metrics["mean_reward"].numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(first["done_count"].numpy(),
                                  metrics["done_frac"].numpy() * 16)
    assert (first["mean_reward"] != 0).any()
    assert first["done_count"][-1] > 0


def test_single_process_mesh():
    """Without a process group the mesh is one rank whose collectives do
    nothing; a larger one needs ranks."""
    mesh = pmesh.make_mesh(device_type="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    t = torch.arange(3.0)
    assert mesh.psum(t) is t and torch.equal(mesh.pmean(t), t)
    with pytest.raises(ValueError, match="init_distributed"):
        pmesh.make_mesh(2, device_type="cpu")
    batch = torch.arange(12).reshape(6, 2)
    assert torch.equal(pmesh.shard_env_batch(batch, mesh), batch)
    cfg = EnvConfig.evaluate(dtype="float64")
    one = presets.circle_scenario(2, radius=2.0).to_state(cfg, device=DEVICE)
    assert pmesh.stack_states([one, one, one]).pos.shape == (3, 2, 2)


def test_profiling_time_step_fn_and_trace(tmp_path):
    """``profiling.trace`` writes a trace whose summary holds the step's ops
    and a ``profiling.span`` opened inside the block."""
    cfg = EnvConfig.evaluate(dtype="float32")
    sc = presets.circle_scenario(4, radius=3.0)
    state, _ = env_reset(sc.to_state(cfg, device=DEVICE), cfg)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("test.block"):
            env_step(state, None, cfg, None, sc.active_policies)
    keys = {e.key for e in prof.key_averages()}
    assert {"aten::add", "test.block", "gca.policy"} <= keys
    assert glob.glob(str(tmp_path / "*.pt.trace.json"))


def test_spawn_local_stops_every_rank_when_one_fails():
    import sys

    code = ("import sys, time\n"
            "rank = int(sys.argv[sys.argv.index('--process-id') + 1])\n"
            "sys.exit(3) if rank == 1 else time.sleep(60)\n")
    with pytest.raises(dist.RankFailed, match="rank 1 exited 3"):
        dist.spawn_local([sys.executable, "-c", code], 3, timeout=30, capture=True)
