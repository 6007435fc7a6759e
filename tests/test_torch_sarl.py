"""SARL (``policies/sarl.py``, ``models/sarl.py``) on the CPU against the
benchmark's plain reference, ``perfbench/reference/sarl.py``, on the seeded
checkpoint at small sizes (E = 8; A = 2, 3 and 6).

The JAX package has no SARL, so the reference is the oracle here.  The
program splits the attention's first layer into ``W_a e_j + (W_b m + b)``
where the reference concatenates ``[e_j, m]``, so their sums round
differently: in float64 the values agree within 1e-12, in float32 within
1e-5 (each of the net's nine products rounds at 2^-24 relative over at most
200 terms, about 1e-7 on these values; 1e-5 leaves a hundredfold room and
is still a hundred times under what bfloat16 weights move them).  The
lookahead's geometry and rewards are the same operations in both, so the
actions are equal except where the reference's two best candidates lie
within that tolerance (a near-tie, which rounding may flip).
"""

import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gym_collision_avoidance_torch import EnvConfig, init_state  # noqa: E402
from gym_collision_avoidance_torch.env import autoreset  # noqa: E402
from gym_collision_avoidance_torch.env.step import env_step  # noqa: E402
from gym_collision_avoidance_torch.harness import registry as hreg  # noqa: E402
from gym_collision_avoidance_torch.harness.serving import AutoresetServer  # noqa: E402
from gym_collision_avoidance_torch.models import sarl  # noqa: E402
from gym_collision_avoidance_torch.policies import registry  # noqa: E402
from gym_collision_avoidance_torch.policies import sarl as sarl_policy  # noqa: E402
from gym_collision_avoidance_torch.scenarios import random_cases  # noqa: E402
from gym_collision_avoidance_torch.utils import profiling  # noqa: E402
from perfbench.reference import sarl as ref  # noqa: E402
from perfbench.reference import sim  # noqa: E402

E = 8
TOL = {"float64": 1e-12, "float32": 1e-5}
WEIGHTS = sarl.CHECKPOINTS["seeded"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(dtype, A):
    return EnvConfig(dtype=dtype, done_mode="evaluate", max_num_other_agents_observed=A - 1)


def _params(dtype):
    return {"sarl": sarl.load_params(dtype=dtype, device="cpu")}


def _mid_episode(dtype, A, steps=6, mixed=False):
    """``E`` envs of ``A`` SARL agents, ``steps`` auto-reset steps in, so
    that agents move; ``mixed`` draws 2..A agents an env, the rest invalid."""
    cfg = _cfg(dtype, A)
    pid = np.full(A, registry.SARL, np.int32)
    pool = (random_cases.scenario_pool_mixed(E, tuple(range(2, A + 1)), seed=A, side_length=4.0)
            if mixed else random_cases.scenario_pool(E, A, seed=A, side_length=4.0))
    step = autoreset.make_autoreset_step(cfg, pool, pid, (registry.SARL,), params=_params(dtype),
                                         device="cpu")
    state = autoreset.state_from_case(cfg, pool, pid, device="cpu")
    counter = torch.arange(E, dtype=torch.int32)
    for _ in range(steps):
        state, counter = step(state, counter)[:2]
    return cfg, state


def _program(state, cfg, params, monkeypatch):
    """``(values, raw, actions)`` of the program, its raw values recorded
    from ``models.sarl.forward_raw`` (the benchmark's recorded function)."""
    calls = []
    orig = sarl.forward_raw

    def recorded(*args):
        calls.append(orig(*args))
        return calls[-1]

    monkeypatch.setattr(sarl, "forward_raw", recorded)
    values, _ = sarl_policy.sarl_values(state, cfg, params)
    actions = sarl_policy.sarl_kernel(state, cfg, params)
    assert len(calls) == 2
    return values, calls[0], actions


def _reference(state, cfg, dtype):
    w = ref.load(WEIGHTS, "cpu", dtype=getattr(torch, dtype))
    rcfg = sim.Config.from_env({"dtype": dtype, "max_num_other_agents_observed":
                                cfg.max_num_other_agents_observed})
    return ref.decide(w, {k: v.clone() for k, v in state.items()}, rcfg, envs_per_block=3)


def _gap(values):
    """The reference's gap between each agent's best and next best value."""
    top = values.amax(dim=-1, keepdim=True)
    second = torch.where(values < top, values, -math.inf).amax(dim=-1)
    return top[..., 0] - second


def test_the_net_has_the_published_widths():
    net = sarl.load_params(device="cpu")
    widths = {name: tuple(m.weight.shape[::-1] for m in getattr(net, name)
                          if isinstance(m, torch.nn.Linear))
              for name in ("mlp1", "mlp2", "attention", "mlp3")}
    assert widths == {"mlp1": ((13, 150), (150, 100)), "mlp2": ((100, 100), (100, 50)),
                      "attention": ((200, 100), (100, 100), (100, 1)),
                      "mlp3": ((56, 150), (150, 100), (100, 100), (100, 1))}
    assert sum(p.numel() for p in net.parameters()) == 96_502
    assert not any(p.requires_grad for p in net.parameters())
    # the shipped checkpoint is the seeded init (scripts/make_sarl_weights.py)
    seeded = sarl.init_params(device="cpu").state_dict()
    assert all(torch.equal(seeded[k], v) for k, v in net.state_dict().items())
    assert sarl.load_params(dtype="float64", device="cpu").dtype == torch.float64


def test_flops_count_the_least_work():
    assert ref.flops(1, 6) == 49_207_500
    assert ref.flops(1, 6) == 81 * (5 * 104_100 + 87_000)
    assert ref.flops(1, 2) == 81 * (104_100 + 87_000)
    assert abs(ref.flops(4096 * 6, 6) - 1.209e12) < 0.001e12


def _by_hand(w, x, present, self6):
    """One row of the value net in numpy float64, written out."""
    def lin(v, name):
        return v @ w[name + ".weight"].T + w[name + ".bias"]

    relu = lambda v: np.maximum(v, 0.0)  # noqa: E731
    e = relu(lin(relu(lin(x, "mlp1.0")), "mlp1.2"))                 # [P, 100]
    h = lin(relu(lin(e, "mlp2.0")), "mlp2.2")                       # [P, 50]
    on = np.flatnonzero(present)
    m = e[on].sum(axis=0) / len(on) if len(on) else np.zeros(100)
    s = np.array([lin(relu(lin(relu(lin(np.concatenate([e[j], m]), "attention.0")),
                                "attention.2")), "attention.4")[0] for j in range(len(x))])
    weights = np.zeros(len(x))
    if len(on):
        weights[on] = np.exp(s[on]) / np.exp(s[on]).sum()
    pooled = (weights[:, None] * h).sum(axis=0)
    z = np.concatenate([self6, pooled])
    for name in ("mlp3.0", "mlp3.2", "mlp3.4"):
        z = relu(lin(z, name))
    return lin(z, "mlp3.6")[0]


@pytest.mark.parametrize("present", [(True, False, True), (True, True, True),
                                     (False, False, False)])
def test_masked_softmax_and_global_mean_by_hand(present):
    """One row of three others: the global state is the mean over the present
    ones, the softmax runs over them alone, and an absent other's features
    change nothing; with none present, nothing is pooled."""
    rng = np.random.RandomState(0)
    x, self6 = rng.randn(3, 13), rng.randn(6)
    with np.load(WEIGHTS) as z:
        w = {k: z[k].astype(np.float64) for k in z.files}
    want = _by_hand(w, x, np.array(present), self6)
    net = sarl.load_params(dtype="float64", device="cpu")
    t = {k: torch.as_tensor(v) for k, v in w.items()}
    args = (torch.as_tensor(x)[None], torch.tensor([present]), torch.as_tensor(self6)[None])
    assert abs(float(sarl.forward_raw(net, *args)[0]) - want) < 1e-12
    assert abs(float(ref.value_net(t, *args)[0]) - want) < 1e-12
    moved = torch.as_tensor(x)[None].clone()
    moved[0, [j for j in range(3) if not present[j]]] += 5.0
    assert abs(float(sarl.forward_raw(net, moved, *args[1:])[0]) - want) < 1e-12


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("A", [2, 3, 6])
def test_values_and_actions_match_the_reference(monkeypatch, dtype, A):
    cfg, state = _mid_episode(dtype, A, mixed=A == 6)
    assert float(state.speed.abs().max()) > 0
    values, raw, actions = _program(state, cfg, _params(dtype), monkeypatch)
    r_actions, r_values, r_raw, ranked = _reference(state, cfg, dtype)
    assert values.shape == raw.shape == (E, A, 81) and values.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    assert float((raw - r_raw).abs().max()) < tol
    assert float((values - r_values).abs().max()) < tol
    same = (actions == r_actions).all(dim=-1)
    assert bool((same | (_gap(r_values) < tol)).all())
    assert int(same.sum()) >= E * A - 1
    stopped = ~ranked
    assert bool((actions[stopped] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_an_exact_tie_reads_a_margin_of_one_ulp(dtype):
    """Candidates after the first maximum that tie it exactly (a region
    where one of the net's hidden layers is all off gives them one V) are
    the runner-up at no distance: the reference puts them an ulp below, so
    the judge's margin reads that ulp, and the argmax is unchanged."""
    from perfbench import check

    values = torch.tensor([[[-0.0513, -0.2, -0.0513, -0.06, -0.0513],
                            [0.3, 0.1, 0.2, 0.25, 0.0]]], dtype=dtype)
    scores = ref.tie_scores(values)
    assert torch.equal(scores.argmax(dim=-1), values.argmax(dim=-1))
    assert torch.equal(scores[0, 1], values[0, 1])
    ulp = float(values[0, 0, 0] - torch.nextafter(values[0, 0, 0], values.new_tensor(-1.0)))
    got = check.margins(scores, torch.ones(1, 2, dtype=torch.bool),
                        torch.zeros(1, 2, dtype=torch.bool))
    assert float(got[0]) == pytest.approx(ulp, rel=1e-6)


def _special_case(dtype, far=(3.0, 3.0)):
    """One env of three agents: agent 0 heads along +x with agent 1 0.1 m
    ahead (so some candidates collide, others come within 0.2 m), agent 1 sits
    0.1 m from its goal, inside its radius, and agent 2 is invalid at
    ``far``."""
    cfg = _cfg(dtype, 3)
    state = init_state(cfg, pos=[[[0.0, 0.0], [0.7, 0.0], list(far)]],
                       goal=[[[3.0, 0.0], [0.8, 0.0], [-3.0, -3.0]]],
                       radius=[[0.3, 0.3, 0.3]], pref_speed=[[1.0, 1.0, 1.0]],
                       policy_id=[[registry.SARL] * 3], valid=[[True, True, False]],
                       device="cpu")
    dtype_ = getattr(torch, dtype)
    return cfg, state.replace(vel=torch.tensor([[[0.8, 0.0], [-0.5, 0.0], [1.0, 1.0]]],
                                               dtype=dtype_))


def test_an_absent_other_a_colliding_candidate_and_an_agent_at_its_goal(monkeypatch):
    cfg, state = _special_case("float64")
    values, raw, actions = _program(state, cfg, _params("float64"), monkeypatch)
    r_actions, r_values, r_raw, ranked = _reference(state, cfg, "float64")
    assert float((values - r_values).abs().max()) < 1e-12
    assert torch.equal(actions, r_actions)
    # agent 1 is within its radius of its goal: it stops, unranked
    assert actions[0, 1].tolist() == [0.0, 0.0] and ranked.tolist() == [[True, False, True]]

    # agent 0's rewards by hand: others 1 (moving -x at 0.5) and 2 (absent)
    reward = sarl_policy._lookahead(state, cfg)[3][0, 0]
    scales = (np.exp(np.arange(1, 6) / 5) - 1) / (np.e - 1)
    rot = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    vel = [(0.0, 0.0)] + [(s * np.cos(t), s * np.sin(t)) for t in rot for s in scales]
    other = np.array([0.7 - 0.5 * 0.2, 0.0])
    want = []
    for vx, vy in vel:
        p = np.array([vx, vy]) * 0.2
        gap = np.linalg.norm(p - other) - 0.6
        want.append(-0.25 if gap < 0 else 1.0 if np.linalg.norm(p - [3.0, 0.0]) < 0.3
                    else (gap - 0.2) * 0.5 * 0.2 if gap < 0.2 else 0.0)
    np.testing.assert_allclose(reward.numpy(), want, rtol=0, atol=1e-15)
    assert {-0.25} < set(want) and any(-0.25 < v < 0 for v in want)

    # the absent other moves nothing
    cfg, moved = _special_case("float64", far=(0.1, 0.1))
    _, raw_moved, _ = _program(moved, cfg, _params("float64"), monkeypatch)
    assert torch.equal(raw_moved[0, :2], raw[0, :2])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_the_reference_follows_the_programs_steps(dtype):
    """Eight auto-reset steps of 6 SARL agents, the reference stepping the
    plain sim from the program's state before each: equal states and
    counters."""
    A = 6
    cfg = _cfg(dtype, A)
    pid = np.full(A, registry.SARL, np.int32)
    pool = random_cases.scenario_pool(16, A, seed=11, side_length=4.0)
    step = autoreset.make_autoreset_step(cfg, pool, pid, (registry.SARL,),
                                         params=_params(dtype), device="cpu")
    state = autoreset.state_from_case(cfg, pool[np.arange(E) % 16], pid, device="cpu")
    counter = torch.arange(E, dtype=torch.int32)
    rcfg = sim.Config.from_env({"dtype": dtype, "max_num_other_agents_observed": A - 1})
    w = ref.load(WEIGHTS, "cpu", dtype=getattr(torch, dtype))
    fresh, fresh_obs = sim.fresh_pool(rcfg, pool, pid, "cpu")
    from perfbench import check

    for _ in range(8):
        s = {k: v.clone() for k, v in state.items()}
        act = ref.decide(w, s, rcfg)[0]
        s, obs, _, over = sim.env_step(s, act, rcfg)
        s, obs, c = sim.reset_where_done(s, obs, counter, over, fresh, fresh_obs)
        state, counter = step(state, counter)[:2]
        diverged, err = check.compare_states(s, c, dict(state.items()), counter)
        assert not bool(diverged.any()) and float(err.max()) == 0.0


def test_sarl_runs_through_the_step_the_loop_and_the_server():
    A = 6
    cfg = _cfg("float32", A)
    pid = np.full(A, registry.SARL, np.int32)
    pool = random_cases.scenario_pool(8, A, seed=2, side_length=4.0)
    params = hreg.load_params(*hreg.POLICY_SPECS["SARL"].needs_params, device="cpu")
    state = autoreset.state_from_case(cfg, pool[:4], pid, device="cpu")
    next_state = env_step(state, None, cfg, params, (registry.SARL,))[0]
    assert bool((next_state.pos != state.pos).any())
    server = AutoresetServer(cfg, pool, pid, num_envs=4, steps_per_dispatch=5, params=params,
                             device="cpu")
    for _ in range(3):
        out = server.dispatch()
        assert torch.isfinite(out["mean_reward"]).all()
        assert torch.isfinite(out["obs_checksum"]).all()
    assert registry.internal_kernel(registry.SARL) is sarl_policy.sarl_kernel
    assert registry.POLICY_NAMES["SARL"] == 10
    with pytest.raises(ValueError, match="params"):
        sarl_policy.sarl_kernel(state, cfg, None)


def test_the_spans_nest_in_the_policy_span(tmp_path):
    from gym_collision_avoidance_torch.harness import paths

    server = paths.serving_path("sarl6", "cpu").server(num_envs=2, steps_per_dispatch=2,
                                                       device="cpu")
    with profiling.trace(str(tmp_path)) as prof:
        server.dispatch()
    ranges = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("gca."):
            ranges.setdefault(e.name, []).append(e.time_range)
    for name in ("gca.sarl.lookahead", "gca.sarl.net"):
        assert len(ranges[name]) == 2
        assert all(sum(p.start <= r.start and r.end <= p.end for p in ranges["gca.policy"]) == 1
                   for r in ranges[name])


def _roofline(kernels, policy="sarl", device_kind="NVIDIA H100 80GB HBM3"):
    import importlib.util

    path = ROOT / "perfbench" / "metrics" / "sarl_net_roofline.py"
    spec = importlib.util.spec_from_file_location("sarl_net_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    config = {"num_agents": 6, "reference": {"policy": policy}}
    trace = types.SimpleNamespace(kernels=kernels, steps=2)
    return module.read(types.SimpleNamespace(config=config, num_envs=4096, num_agents=6,
                                             trace=trace, device_kind=device_kind))


def test_the_roofline_reader():
    gemm = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8"
    assert _roofline([]) is None
    assert _roofline([("elementwise_kernel", 0.0, 1.0)]) is None
    assert _roofline([(gemm, 0.0, 1.0)], policy="cadrl") is None
    assert _roofline([(gemm, 0.0, 1.0)], device_kind="cpu") is None
    # 1.209 TFLOP a step at 67 TFLOP/s is 18.05 ms; two steps of products
    # taking 72.2 ms (the elementwise kernel left out) read 50%
    bound = ref.flops(4096 * 6, 6) / 67e12
    kernels = [(gemm, 0.0, bound), ("elementwise_kernel", 1.0, 2.0),
               ("sarl_pool_kernel", 2.0, 2.0 + 3 * bound)]
    assert _roofline(kernels) == pytest.approx(50.0)
