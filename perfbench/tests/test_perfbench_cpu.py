"""CPU tests of the benchmark: its generator, counts, manifest, reference,
comparison and control, at tiny sizes.  Run from the repository root:

    python -m pytest -q perfbench/tests
"""

from __future__ import annotations

import ast
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import check, faults, flops, reference, run, scenarios  # noqa: E402
from perfbench.reference import sim  # noqa: E402

CELLS = ("ga3c4.serve", "cadrl4.serve16k", "drl_long4.serve16k")
# the laser cell whose policy takes no argmax, judged by its step margins
DRL = "drl_long4.serve16k"
TINY = {"num_envs": 8, "warmup_dispatches": 1, "trace_dispatches": 3,
        "check": {"window_samples": 2, "window_first": 2, "after_dispatches": 1}}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY_TRAIN = {"recipe": {**run.load_json(ROOT / "perfbench" / "traffic" / "train.json")["recipe"],
                         "num_envs": 4, "horizon": 6, "epochs": 2, "num_minibatches": 2},
              "reference_iterations": 2, "trace_iterations": 2}


# The training cell that BENCHMARK.json leaves out for now (PERF.md §7), with
# its metrics: its kind, reference and limits stay, tested here.
TRAIN_CELL = {"name": "ga3c4.train", "config": "ga3c4", "traffic": "train", "chips": 1}
TRAIN_METRICS = {
    "end_to_end": [{"name": "train_env_steps_per_s", "unit": "env-steps/s",
                    "workloads": ["ga3c4.train"]}],
    "per_layer": [{"name": name, "unit": unit, "moves": "train_env_steps_per_s",
                   "workloads": ["ga3c4.train"]}
                  for name, unit in (("rollout_ms_per_iter.train", "ms"),
                                     ("update_ms_per_iter.train", "ms"), ("mfu.train", "%"),
                                     ("device_idle_pct.train", "%"))]}


@pytest.fixture
def train_cell(monkeypatch):
    """The manifest as read, with the training cell and its metrics added."""
    load_json = run.load_json

    def with_train(path):
        data = load_json(path)
        if Path(path).name != "BENCHMARK.json":
            return data
        return dict(data, workloads=data["workloads"] + [TRAIN_CELL],
                    **{k: data[k] + v for k, v in TRAIN_METRICS.items()})

    monkeypatch.setattr(run, "load_json", with_train)


# The laser test configuration (no cell of BENCHMARK.json) as a cell at
# ga3c4.serve's traffic and limits.
LASER = "laser_ga3c4.serve"
LASER_CONFIG = ROOT / "perfbench" / "tests" / "laser_ga3c4.json"


@pytest.fixture
def laser_cell(monkeypatch):
    """``run.load_cell`` that also knows :data:`LASER`."""
    load_cell = run.load_cell

    def with_laser(workload):
        if workload != LASER:
            return load_cell(workload)
        loaded = load_cell("ga3c4.serve")
        cell = dict(loaded["cell"], name=LASER, config="laser_ga3c4")
        manifest = dict(loaded["manifest"],
                        workloads=loaded["manifest"]["workloads"] + [cell])
        return dict(loaded, manifest=manifest, cell=cell, config=run.load_json(LASER_CONFIG))

    monkeypatch.setattr(run, "load_cell", with_laser)


def tiny_run(workload, seed=2**31 + 77, trace=False, control="", overrides=TINY):
    return run.run_cell(workload, seed, 0.3, trace, device="cpu", t_start=time.perf_counter(),
                        control=control, overrides=overrides)


@pytest.mark.parametrize("seed", [0, 12345, 2**32 - 1])
def test_generator_equals_the_programs_pool(seed):
    from gym_collision_avoidance_torch.scenarios import random_cases

    np.testing.assert_array_equal(scenarios.scenario_pool(16, 4, seed=seed),
                                  random_cases.scenario_pool(16, 4, seed=seed, side_length=4.0))


def test_flop_and_byte_counts():
    ga3c = {"num_agents": 4, "reference": {"policy": "ga3c"}}
    cadrl = {"num_agents": 4, "reference": {"policy": "cadrl"}}
    # LSTM 3 x 71 x 256, dense 68 x 256 + 2 x 256 x 256, heads 256 x 12, x2, x 16384 rows
    assert flops.policy_flops_per_step(ga3c, 4096) == 2.0 * 16384 * (3 * 71 * 256 + 68 * 256
                                                                     + 2 * 256 * 256 + 256 * 12)
    assert abs(flops.policy_flops_per_step(ga3c, 4096) - 6.75e9) < 0.01e9
    # 770048 rows of 31 x 200 + 200 x 200 + 100 x 50 + 50 x 1
    assert flops.policy_flops_per_step(cadrl, 4096) == 2.0 * 770048 * 51250
    assert flops.k1_bytes(4096, 4) == 16384 * 31
    assert flops.k1_flops(4096, 4) == 8.0 * 4096 * 16
    # conv1 3 x 5 x 32 x 255, conv2 32 x 3 x 32 x 128, 4096 x 256, 260 x 128, 128 x 2; x2
    drl = {"num_agents": 4, "reference": {"policy": "drl_long"}}
    assert flops.policy_flops_per_step(drl, 1) == 4 * 3195456.0
    assert 3195456 == 2 * (3 * 5 * 32 * 255 + 32 * 3 * 32 * 128 + 4096 * 256 + 260 * 128 + 128 * 2)
    # pose (12 B), radius (4 B) and valid (1 B) in, 512 float32 ranges out, an agent
    assert flops.k2_bytes(16384, 4, 512) == 65536 * (17 + 2048)
    assert abs(flops.k2_bytes(16384, 4, 512) / 3.35e12 - 0.0404e-3) < 0.0001e-3


def test_every_cell_resolves_to_its_files(train_cell):
    manifest = run.load_json(ROOT / "BENCHMARK.json")
    for cell in manifest["workloads"]:
        loaded = run.load_cell(cell["name"])
        assert loaded["config"]["name"] == cell["config"]
        assert (ROOT / loaded["config"]["reference"]["weights"]).exists()
        policy = reference.module(loaded["config"]["reference"]["policy"])
        assert all(callable(getattr(policy, f)) for f in ("load", "decide", "flops",
                                                          "output_error"))
        if loaded["traffic"]["kind"] == "train":
            names = loaded["config"]["train"]["reference"]
            assert (ROOT / names["weights"]).exists()
            net = reference.module(names["net"])
            assert all(callable(getattr(net, f)) for f in ("load_train", "train_net",
                                                           "to_actions"))
            assert callable(reference.module(names["algorithm"]).iteration)
        assert loaded["limits"]
        e2e = run.end_to_end_metrics(manifest, cell["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        layers = run.per_layer_metrics(manifest, cell["name"])
        assert layers
        assert {m["moves"] for m in layers} <= {m["name"] for m in e2e}
        for metric in layers:
            assert callable(run.metric_reader(metric["name"]))


def test_reference_imports_nothing_of_the_program():
    paths = sorted((ROOT / "perfbench" / "reference").glob("*.py"))
    assert {"sim.py", "ga3c.py", "cadrl.py", "ppo.py", "drl_long.py"} <= {p.name for p in paths}
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                                  "gym_collision_avoidance_tpu",
                                                  "gym_collision_avoidance_torch"), (path, name)


@pytest.mark.parametrize("workload", CELLS + (LASER,))
def test_reference_follows_the_programs_cpu_step(laser_cell, workload):
    """Ten steps of the program's auto-reset step on the CPU, in the world
    that a run gives it, the reference following each from the program's
    state: equal states and counters (the laser's scan history and count
    among them)."""
    from gym_collision_avoidance_torch.config import EnvConfig
    from gym_collision_avoidance_torch.env import autoreset
    from perfbench.kinds import serve

    loaded = run.load_cell(workload)
    config = loaded["config"]
    A = config["num_agents"]
    pool = scenarios.scenario_pool(8, A, seed=3)
    policy_id = np.full(A, config["policy_id"], np.int32)
    params = serve._program_params(config, "cpu")
    env = EnvConfig(**config["env"])
    step = autoreset.make_autoreset_step(env, pool, policy_id, (config["policy_id"],),
                                         params=params, device="cpu",
                                         **serve._world(config, env, "cpu"))
    state = autoreset.state_from_case(env, pool[np.arange(6) % 8], policy_id, device="cpu")
    counter = torch.arange(6, dtype=torch.int32)
    cfg = sim.Config.from_env(config["env"], config.get("world"))
    policy = reference.module(config["reference"]["policy"])
    weights = policy.load(str(ROOT / config["reference"]["weights"]), "cpu")
    fresh, fresh_obs = sim.fresh_pool(cfg, pool, policy_id, "cpu")
    for _ in range(10):
        s = {k: v.clone() for k, v in state.items()}
        act, _, _, _ = policy.decide(weights, s, cfg)
        s, obs, _, game_over = sim.env_step(s, act, cfg)
        s, obs, c = sim.reset_where_done(s, obs, counter, game_over, fresh, fresh_obs)
        state, counter = step(state, counter)[:2]
        diverged, err = check.compare_states(s, c, dict(state.items()), counter)
        assert not bool(diverged.any()) and float(err.max()) == 0.0


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_is_correct_and_judged(workload):
    line = tiny_run(workload)
    assert line["correct"], line["check"]
    assert list(line)[-1] == "check"
    # the host-paced cell's rate is a per-layer metric (PERF.md §6)
    rate = set() if workload == "ga3c4.serve" else {"env_steps_per_s"}
    assert set(line["metrics"]) == rate | {"dispatch_p95_ms", "setup_s"}
    assert line["check"]["diverged_share"]["value"] == 0.0
    steps = TINY["check"]["after_dispatches"] * run.load_cell(workload)["traffic"][
        "steps_per_dispatch"]
    assert line["policy_steps_compared"] == {"steps": steps, "of": steps}


def test_a_laser_run_is_correct_and_judged(laser_cell):
    line = tiny_run(LASER)
    assert line["correct"], line["check"]
    assert line["check"]["diverged_share"]["value"] == 0.0
    assert line["check"]["float_err"]["value"] <= 1e-6


@pytest.mark.parametrize("workload", (LASER, DRL))
@pytest.mark.parametrize("fault", faults.LASER)
def test_a_broken_scan_is_not_correct(laser_cell, workload, fault):
    """Every range moved by a sample, or one range of one env's scan: in the
    DRL-Long cell at this size that one env's own margin, 1.5e-5 m, lies
    under the 2e-5 limit, so it fails on the share of parted envs."""
    with faults.planted("serve", fault):
        line = tiny_run(workload)
    assert not line["correct"], (fault, line["check"])


def test_an_env_parted_far_from_every_branch_fails_on_flip_margin():
    """A dispatch of the reference itself, in envs whose agents face away
    from each other (no beam hits) and head for goals 5.7 m off: one range
    of one env's scan altered after it parts that env, whose every
    comparison is far from its threshold, so ``flip_margin`` fails."""
    config = run.load_json(ROOT / "perfbench" / "configs" / "drl_long4.json")
    cfg = sim.Config.from_env(config["env"], config["world"])
    policy = reference.module("drl_long")
    w = policy.load(str(ROOT / config["reference"]["weights"]), "cpu")
    corners = np.array([[3.03, 2.96], [-2.94, 3.07], [-3.05, -2.93], [2.92, -3.06]])
    case = np.concatenate([corners, corners * 7.0 / 3.0, np.full((4, 1), 1.0),
                           np.full((4, 1), 0.3)], axis=-1)
    pool = np.stack([case, case[::-1]]).astype(np.float32)
    policy_id = np.full(4, config["policy_id"], np.int32)
    start = (sim.init_states(cfg, pool, policy_id, "cpu"), torch.arange(2, dtype=torch.int32))
    fresh, fresh_obs = sim.fresh_pool(cfg, pool, policy_id, "cpu")
    s, c = dict(fresh), start[1].clone()
    for _ in range(8):
        act = policy.decide(w, s, cfg)[0]
        s, obs, _, game_over = sim.env_step(s, act, cfg)
        s, obs, c = sim.reset_where_done(s, obs, c, game_over, fresh, fresh_obs)
    assert float(sim.laserscan(s, cfg).min()) == sim.LASER_MAX_RANGE
    limits = run.load_json(ROOT / "perfbench" / "limits" / f"{DRL}.json")
    altered = s["laserscan_history"].clone()
    altered[0, 0, 0, 256] += 0.1
    for history, parted in ((s["laserscan_history"], False), (altered, True)):
        sample = {"before": (dict(fresh), start[1].clone()), "read": {},
                  "after": (dict(s, laserscan_history=history), c)}
        readings, _ = check.judge_serving(config, pool, start, [sample], 8, (), "cpu")
        assert (readings["diverged_share"] > 0) == parted, readings
        assert (readings["flip_margin"] > limits["flip_margin"]) == parted, readings


def _two_agents(x0):
    """States of one env: agent 0 at ``(x0, 0.05)`` facing +x, agent 1 (radius
    0.25 m, centre cell (79, 87): its disc covers columns 85-89 of row 79)
    at ``(0.75, 0.05)``, on the 16 m map of 0.1 m cells, three beams."""
    config = run.load_json(ROOT / "perfbench" / "configs" / "drl_long4.json")
    cfg = sim.Config.from_env(dict(config["env"], laserscan_length=3), config["world"])
    case = np.array([[[x0, 0.05, 3.0, 0.05, 1.0, 0.2], [0.75, 0.05, -3.0, 0.05, 1.0, 0.25]]],
                    np.float32)
    return sim.init_states(cfg, case, np.array([9, 9], np.int32), "cpu"), cfg


def test_a_scan_sample_on_a_cell_edge_has_a_margin_of_zero():
    """Agent 0's middle beam samples x0 + k * 0.1: at x0 = 0 sample 5 lies on
    column 85's edge, the first cell of agent 1's disc, so a rounding there
    decides the range; at x0 = 0.02 it lies 0.2 cells inside."""
    s, cfg = _two_agents(0.0)
    assert float(sim.scan_margins(s, cfg)[0, 0]) == 0.0
    s, cfg = _two_agents(0.02)
    assert abs(float(sim.scan_margins(s, cfg)[0, 0]) - 0.02) < 1e-5
    before = dict(s, is_done=torch.zeros_like(s["is_done"]))
    assert float(sim.step_margins(before, s, cfg)[0]) <= 0.02 + 1e-5


class _Built(Exception):
    """Raised in place of building the server, once its arguments are read."""


def _serve_cells(world: bool):
    """The serving cells of ``BENCHMARK.json`` whose configuration names a
    ``world``, or names none."""
    return [w["name"] for w in run.load_json(ROOT / "BENCHMARK.json")["workloads"]
            if run.load_cell(w["name"])["traffic"]["kind"] == "serve"
            and ("world" in run.load_cell(w["name"])["config"]) == world]


def _server_arguments(monkeypatch, workload) -> dict:
    """The arguments a run hands ``AutoresetServer``, which is not built."""
    import inspect

    from gym_collision_avoidance_torch.harness import serving

    init = serving.AutoresetServer.__init__
    got = {}

    def record(*args, **kwargs):
        bound = inspect.signature(init).bind(*args, **kwargs)
        bound.apply_defaults()
        got.update(bound.arguments)
        raise _Built

    monkeypatch.setattr(serving.AutoresetServer, "__init__", record)
    with pytest.raises(_Built):
        tiny_run(workload)
    return got


@pytest.mark.parametrize("workload", _serve_cells(world=False))
def test_a_configuration_naming_no_world_keeps_the_servers_defaults(monkeypatch, workload):
    """A configuration without ``world`` hands ``AutoresetServer`` what it
    was handed before worlds existed: the default sensors and observation
    keys, and no map."""
    from gym_collision_avoidance_torch.obs import spec

    got = _server_arguments(monkeypatch, workload)
    assert got["sensors"] == ("other_agents_states",)
    assert got["states_in_obs"] == spec.DEFAULT_STATES_IN_OBS
    assert got["static_map"] is None and got["static_cells"] is None


@pytest.mark.parametrize("workload", _serve_cells(world=True))
def test_a_configuration_naming_a_world_hands_it_to_the_server(monkeypatch, workload):
    """A configuration with ``world`` hands ``AutoresetServer`` its sensors
    and observation keys, the empty map at the env's size and an empty list
    of occupied cells."""
    world = run.load_cell(workload)["config"]["world"]
    got = _server_arguments(monkeypatch, workload)
    assert got["sensors"] == tuple(world["sensors"])
    assert got["states_in_obs"] == tuple(world["states_in_obs"])
    cfg = got["cfg"]
    H = int(round(cfg.map_y_width / cfg.map_grid_cell_size))
    W = int(round(cfg.map_x_width / cfg.map_grid_cell_size))
    assert tuple(got["static_map"].shape) == (H, W) and not bool(got["static_map"].any())
    assert got["static_cells"].shape[0] == 0


@pytest.mark.parametrize("key, value", [("laserscan_num_candidate_discs", 9),
                                        ("laserscan_entry_window", 12),
                                        ("laserscan_beam_slots", 4), ("collision_dist", 0.1)])
def test_the_reference_refuses_what_it_does_not_model(key, value):
    config = run.load_json(LASER_CONFIG)
    with pytest.raises(ValueError, match="does not model"):
        sim.Config.from_env(dict(config["env"], **{key: value}), config["world"])


@pytest.mark.parametrize("env, world", [
    ({}, {"static_map": "002"}), ({}, {"sensors": ["occupancy_grid"]}),
    ({}, {"sensors": [["laserscan", [0]]]}), ({}, {"map": "empty"}),
    ({"use_static_map": False}, {})])
def test_the_reference_refuses_a_world_it_does_not_model(env, world):
    config = run.load_json(LASER_CONFIG)
    with pytest.raises(ValueError):
        sim.Config.from_env(dict(config["env"], **env), dict(config["world"], **world))


def test_a_bypassed_policy_output_is_reported(monkeypatch):
    """Where the program never calls the function that returns the policy's
    outputs, the run says that none was compared, and still judges the
    rest."""
    load_cell = run.load_cell

    def without_output(workload):
        loaded = load_cell(workload)
        program = dict(loaded["config"]["program"], policy_output=None)
        return dict(loaded, config=dict(loaded["config"], program=program))

    monkeypatch.setattr(run, "load_cell", without_output)
    line = tiny_run("ga3c4.serve")
    assert line["policy_steps_compared"]["steps"] == 0
    assert line["policy_steps_compared"]["of"] > 0
    assert line["correct"], line["check"]


def test_a_traced_run_reads_its_layers():
    line = tiny_run("ga3c4.serve", trace=True)
    assert line["correct"]
    assert {"enqueue_ms_per_step.serve", "host_env_steps_per_s"} <= set(line["metrics"])
    assert line["device"]["window_s"] > 0 and "breakdown" in line


@pytest.mark.parametrize("workload", CELLS)
def test_lower_precision_fails(workload):
    """The control: the program's net with bfloat16-rounded weights."""
    line = tiny_run(workload, control="bf16_weights")
    assert not line["correct"]
    assert line["check"]["float_err"]["value"] > line["check"]["float_err"]["limit"]


@pytest.mark.parametrize("fault", faults.SERVE)
def test_a_broken_step_is_not_correct(fault):
    with faults.planted("serve", fault):
        line = tiny_run("ga3c4.serve")
    assert not line["correct"], (fault, line["check"])


def test_a_training_run_is_correct_and_judged(train_cell):
    line = tiny_run("ga3c4.train", overrides=TINY_TRAIN)
    assert line["correct"], line["check"]
    assert set(line["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    # the program's bits; the loss differs by its float32 mean over minibatches
    assert {k: c["value"] for k, c in line["check"].items() if k != "loss_gap"} == {
        "grad_gap": 0.0, "change_gap": 0.0, "diverged_share": 0.0}


def test_a_traced_training_run_reads_its_layers(train_cell):
    line = tiny_run("ga3c4.train", trace=True, overrides=TINY_TRAIN)
    assert line["correct"]
    assert {"rollout_ms_per_iter.train", "update_ms_per_iter.train"} <= set(line["metrics"])


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_a_broken_training_step_is_not_correct(train_cell, fault):
    with faults.planted("train", fault):
        line = tiny_run("ga3c4.train", overrides=TINY_TRAIN)
    assert not line["correct"], (fault, line["check"])


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r); import torch; torch.set_num_threads(1);"
            "from perfbench import run; from perfbench.tests.test_perfbench_cpu import TINY;"
            "run.run_cell('ga3c4.serve', 5, 0.2, False, device='cpu', overrides=TINY);"
            "print(run.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ga3c4.serve", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
