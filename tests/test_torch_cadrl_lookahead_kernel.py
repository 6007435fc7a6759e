"""SA-CADRL's lookahead kernel (``ops/cadrl_lookahead.py``,
``csrc/cadrl_lookahead.cu``) against the plain route.

On the CPU: which configurations take the kernel (a CUDA device in
``no_constr`` mode with no passing side) and which keep the plain route
(the CPU, ``rotate_constr``, the passing sides), launching nothing; the
wrapper's refusals of what the kernel does not take, before anything is
built; and the wrapper's outputs, which carry the plain version's fields,
shapes and dtypes.

On the card (``cuda`` marker; imports neither JAX nor ``tests/conftest.py``'s
setup)::

    python -m pytest --noconftest -q tests/test_torch_cadrl_lookahead_kernel.py

the kernel against ``policies/cadrl.py:_lookahead_plain`` on the card:
``states_nn`` and every aux field bitwise in float32 and within 1e-12 in
float64, at cadrl4's ``[16384, 4]`` and at agent counts that leave a ragged
last block, with A = 2, 4 and 10; on hand-built edge cases (0 to 3 present
others in every pattern, coincident agents, an agent at its goal, goals over
30 m away, headings at +-pi, standing others, a padded agent with no
preferred speed); one cadrl4 step whose value-net input and actions equal
the plain route's; and one launch a step on the cadrl4 server.
"""

import math

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import EnvConfig, init_state, ops
from gym_collision_avoidance_torch.models import cadrl as cadrl_net
from gym_collision_avoidance_torch.ops import build, cadrl_lookahead
from gym_collision_avoidance_torch.policies import cadrl as cadrl_policy
from gym_collision_avoidance_torch.policies import registry

CONFIGS = {
    "no_constr": {},
    "rotate_constr": {"cadrl_mode": "rotate_constr", "cadrl_passing_side": "right"},
    "no_constr_right": {"cadrl_passing_side": "right"},
    "no_constr_left": {"cadrl_passing_side": "left"},
}


def _states(seed, E, A, device, dtype=torch.float32, invalid=0.0, cfg=None):
    """Seeded ``[E, A]`` SA-CADRL states with random velocities and past
    velocities; a share ``invalid`` of the agents is switched off, so that
    agents see 0 to 3 others."""
    rng = np.random.RandomState(seed)
    if cfg is None:
        cfg = EnvConfig(dtype="float32" if dtype == torch.float32 else "float64")
    st = init_state(cfg, rng.uniform(-4, 4, (E, A, 2)), rng.uniform(-4, 4, (E, A, 2)),
                    rng.uniform(0.2, 0.6, (E, A)), rng.uniform(0.5, 1.5, (E, A)),
                    heading=rng.uniform(-np.pi, np.pi, (E, A)),
                    policy_id=np.full((E, A), registry.CADRL, np.int32), device=device)
    K = st.past_vel.shape[-2]
    st = st.replace(
        vel=torch.as_tensor(rng.uniform(-1, 1, (E, A, 2)), dtype=dtype, device=device),
        past_vel=torch.as_tensor(rng.uniform(-1, 1, (E, A, K, 2)), dtype=dtype, device=device))
    if invalid:
        valid = torch.as_tensor(rng.uniform(size=(E, A)) >= invalid, device=device)
        st = st.replace(valid=st.valid & valid)
    return cfg, st


def _inputs(state, cfg):
    """The kernel's inputs, as ``_cadrl_prepare`` makes them."""
    others_s10, others_action, present, _num = cadrl_policy._select_others(state, cfg)
    return cadrl_policy._ego_s10(state), others_s10, others_action, present


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_route_choice(config, device):
    """Only a CUDA device in no_constr mode with no passing side takes the
    kernel; the choice reads the configuration and the device alone."""
    cfg = EnvConfig(dtype="float32").replace(**CONFIGS[config])
    want = device == "cuda" and config == "no_constr"
    assert cadrl_policy._takes_kernel(torch.device(device), cfg) is want


@pytest.mark.parametrize("config", ["no_constr", "rotate_constr", "no_constr_right"])
def test_cpu_takes_the_plain_route_and_launches_nothing(config, monkeypatch):
    cfg, st = _states(3, 2, 4, "cpu")
    cfg = cfg.replace(**CONFIGS[config])
    checkpoint = "rotate_constr_right" if config == "rotate_constr" else "no_constr"
    params = {"cadrl": cadrl_net.load_params(checkpoint, device="cpu")}

    def refused(*args, **kwargs):
        raise AssertionError("the CPU reached the kernel's wrapper")

    monkeypatch.setattr(cadrl_lookahead, "lookahead_cuda", refused)
    before = ops.launch_counts()["cadrl_lookahead"]
    states_nn, aux = cadrl_policy._cadrl_prepare(st, cfg)
    action = cadrl_policy.cadrl_kernel(st, cfg, params)
    assert ops.launch_counts()["cadrl_lookahead"] == before
    candidates = 38 if config == "rotate_constr" else 47
    assert states_nn.shape == (2, 4, candidates, 31) and action.shape == (2, 4, 2)
    plain_nn, plain_aux = cadrl_policy._lookahead_plain(*_inputs(st, cfg), cfg)
    assert torch.equal(states_nn, plain_nn)
    assert sorted(aux) == sorted([*plain_aux, "pref", "heading_h", "heading_ego_h",
                                  "num_present"])


def _good(lead=(3, 4), dtype=torch.float32):
    return (torch.zeros(*lead, 10, dtype=dtype), torch.zeros(*lead, 3, 10, dtype=dtype),
            torch.zeros(*lead, 3, 2, dtype=dtype), torch.zeros(*lead, 3, dtype=torch.bool))


def _refusals():
    s10, others, action, present = _good()
    return {
        "float16": (TypeError, "float32 or float64", (s10.half(), others.half(), action.half(),
                                                      present)),
        "bfloat16": (TypeError, "float32 or float64", (s10.bfloat16(), others.bfloat16(),
                                                       action.bfloat16(), present)),
        "mixed_dtype": (TypeError, "others_action must be", (s10, others, action.double(),
                                                             present)),
        "present_not_bool": (TypeError, "present must be", (s10, others, action,
                                                            present.to(torch.uint8))),
        "s10_width": (ValueError, "s10 must be", (s10[..., :9].contiguous(), others,
                                                         action, present)),
        "others_width": (ValueError, "others_s10 must be", (s10, others[..., :9].contiguous(),
                                                            action, present)),
        "slots": (ValueError, "others_action must be", (s10, others, action[..., :2, :]
                                                        .contiguous(), present)),
        "not_contiguous": (ValueError, "s10 must be contiguous", (
            s10.transpose(0, 1).contiguous().transpose(0, 1), others, action, present)),
        "cpu": (ValueError, "CUDA device", (s10, others, action, present)),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_wrapper_refuses_before_any_build(case, monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel was built")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    error, message, args = _refusals()[case]
    before = ops.launch_counts()["cadrl_lookahead"]
    with pytest.raises(error, match=message):
        cadrl_lookahead.lookahead_cuda(*args)
    assert ops.launch_counts()["cadrl_lookahead"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_outputs_have_the_plain_layout(dtype, monkeypatch):
    """The wrapper's outputs (kernel launch stubbed out) carry the plain
    version's aux fields with its shapes and dtypes; the launch gets E * A
    agents and contiguous buffers."""
    cfg, st = _states(4, 3, 4, "cpu", dtype)
    inputs = _inputs(st, cfg)
    plain_nn, plain_aux = cadrl_policy._lookahead_plain(*inputs, cfg)
    launches = []

    class Stub:
        check = cadrl_lookahead.KERNEL.check

        def __call__(self, dt, *args, device):
            launches.append((dt, args, device))

    monkeypatch.setattr(build, "check_launch_args", lambda fields, device: None)
    monkeypatch.setattr(cadrl_lookahead, "KERNEL", Stub())
    states_nn, aux = cadrl_lookahead.lookahead_cuda(*inputs)
    assert len(launches) == 1
    dt, args, device = launches[0]
    assert dt == dtype and device == st.pos.device and args[-1] == 12
    assert args[:4] == tuple(t.data_ptr() for t in inputs)
    assert (states_nn.shape, states_nn.dtype) == (plain_nn.shape, plain_nn.dtype)
    assert states_nn.is_contiguous()
    assert sorted(aux) == sorted(plain_aux)
    for name, t in plain_aux.items():
        assert (aux[name].shape, aux[name].dtype) == (t.shape, t.dtype), name
    assert aux["dist_col"].data_ptr() == states_nn.data_ptr()


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want, atol):
    """Equal with NaN equal to NaN and -0.0 apart from +0.0 (bitwise for
    atol 0), or within atol."""
    if not got.is_floating_point():
        return torch.equal(got, want)
    both_nan = torch.isnan(got) & torch.isnan(want)
    if atol == 0:
        return bool((both_nan | ((got == want) & (torch.signbit(got) == torch.signbit(want))))
                    .all())
    return bool((both_nan | ((got - want).abs() <= atol)).all())


TOL = {torch.float32: 0.0, torch.float64: 1e-12}


def _abs_err(got, want):
    """Largest |got - want| of a float field (0 where both are equal or
    both NaN, so equal infinities count as 0); 0 for a flag field."""
    if not got.is_floating_point():
        return 0.0
    got, want = got.double(), want.double()
    equal = (got == want) | (torch.isnan(got) & torch.isnan(want))
    return float(torch.where(equal, 0.0, (got - want).abs()).max())


def _hold(inputs, cfg, what):
    """The kernel on ``inputs`` against the plain route, every field;
    returns the largest |kernel - plain| over ``states_nn`` and the float
    aux fields."""
    dtype = inputs[0].dtype
    before = ops.launch_counts()["cadrl_lookahead"]
    got_nn, got_aux = cadrl_lookahead.lookahead_cuda(*inputs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cadrl_lookahead"] == before + 1
    want_nn, want_aux = cadrl_policy._lookahead_plain(*inputs, cfg)
    bad = [name for name, t in want_aux.items() if not _same(got_aux[name], t, TOL[dtype])]
    if not _same(got_nn, want_nn, TOL[dtype]):
        cols = [f for f in range(31) if not _same(got_nn[..., f], want_nn[..., f], TOL[dtype])]
        bad.append(f"states_nn columns {cols}")
    assert not bad, f"{what}: the kernel differs from the plain route in {bad}"
    return max(_abs_err(got_nn, want_nn),
               *(_abs_err(got_aux[name], t) for name, t in want_aux.items()))


SHAPES = [(torch.float32, 16384, 4, 0.0), (torch.float32, 7, 3, 0.0),
          (torch.float32, 9, 2, 0.3), (torch.float32, 13, 10, 0.3),
          (torch.float32, 1025, 4, 0.4), (torch.float64, 7, 3, 0.0),
          (torch.float64, 13, 10, 0.3), (torch.float64, 4096, 4, 0.4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,E,A,invalid", SHAPES)
def test_kernel_matches_plain_route(cuda_device, dtype, E, A, invalid):
    cfg, st = _states(E * 31 + A, E, A, cuda_device, dtype, invalid)
    inputs = _inputs(st, cfg)
    counts = torch.bincount(inputs[3].sum(-1).flatten(), minlength=4).tolist()
    _hold(inputs, cfg, f"{dtype} E={E} A={A} present counts {counts}")


def _edge_inputs(dtype, device):
    """Hand-built agents, each against 3 slots in one of the 8 presence
    patterns: a random agent, coincident agents (others at the ego's
    position, zero dot products), an agent at its goal, a goal 40 m away,
    headings at +pi and -pi (for the ego and the others' actions), standing
    others (zero filtered action), and a padded agent (no preferred speed,
    radius 0, at its goal)."""
    rng = np.random.RandomState(5)
    kinds = ["random", "coincident", "at_goal", "far_goal", "plus_pi", "minus_pi",
             "standing", "padded"]
    n = len(kinds) * 8
    s10 = np.zeros((n, 10))
    others = np.zeros((n, 3, 10))
    action = np.zeros((n, 3, 2))
    present = np.zeros((n, 3), bool)
    for i in range(n):
        kind, pattern = kinds[i // 8], i % 8
        pos = rng.uniform(-3, 3, 2)
        s10[i, 0:2] = pos
        s10[i, 2:4] = rng.uniform(-1, 1, 2)
        s10[i, 4] = rng.uniform(-np.pi, np.pi)
        s10[i, 5] = rng.uniform(0.5, 1.5)
        s10[i, 6:8] = rng.uniform(-4, 4, 2)
        s10[i, 8] = rng.uniform(0.2, 0.6)
        others[i, :, 0:2] = pos + rng.uniform(-2, 2, (3, 2))
        others[i, :, 4] = rng.uniform(-np.pi, np.pi, 3)
        others[i, :, 5] = rng.uniform(0.5, 1.5, 3)
        others[i, :, 6:8] = rng.uniform(-4, 4, (3, 2))
        others[i, :, 8] = rng.uniform(0.2, 0.6, 3)
        action[i, :, 0] = rng.uniform(0, 1.5, 3)
        action[i, :, 1] = rng.uniform(-np.pi, np.pi, 3)
        present[i] = [(pattern >> b) & 1 for b in range(3)]
        if kind == "coincident":
            others[i, :, 0:2] = pos
            s10[i, 2:4] = 0.0
        elif kind == "at_goal":
            s10[i, 6:8] = pos
        elif kind == "far_goal":
            s10[i, 6:8] = pos + 40.0 * np.array([np.cos(i), np.sin(i)])
        elif kind in ("plus_pi", "minus_pi"):
            sign = 1.0 if kind == "plus_pi" else -1.0
            s10[i, 4] = sign * np.pi
            action[i, :, 1] = sign * np.pi
            s10[i, 6:8] = pos + np.array([-3.0, 0.0])          # the goal behind, at +-pi
        elif kind == "standing":
            action[i] = 0.0
        elif kind == "padded":
            s10[i] = 0.0
            s10[i, 6:8] = 0.0
    return tuple(torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else dtype,
                                 device=device).contiguous()
                 for a in (s10, others, action, present))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_route_on_edge_cases(cuda_device, dtype):
    cfg = EnvConfig(dtype="float32" if dtype == torch.float32 else "float64")
    _hold(_edge_inputs(dtype, cuda_device), cfg, f"{dtype} edge cases")


@pytest.mark.cuda
def test_cadrl4_step_matches_the_plain_route(cuda_device, monkeypatch):
    """One cadrl4 step: the value net's input and the actions of the kernel
    route equal the plain route's bitwise."""
    from gym_collision_avoidance_torch.harness import paths

    path = paths.serving_path("cadrl4", cuda_device)
    cfg, st = _states(21, 4096, 4, cuda_device, cfg=path.cfg)
    rows = []
    plain = cadrl_net.forward_raw

    def recorded(params, x):
        rows.append(x.clone())
        return plain(params, x)

    monkeypatch.setattr(cadrl_net, "forward_raw", recorded)
    before = ops.launch_counts()["cadrl_lookahead"]
    got = cadrl_policy.cadrl_kernel(st, cfg, path.params)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cadrl_lookahead"] == before + 1
    monkeypatch.setattr(cadrl_policy, "_takes_kernel", lambda device, cfg: False)
    want = cadrl_policy.cadrl_kernel(st, cfg, path.params)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cadrl_lookahead"] == before + 1
    assert len(rows) == 2 and torch.equal(rows[0], rows[1])
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cadrl4_step_launches_the_lookahead_once(cuda_device):
    from gym_collision_avoidance_torch.harness import paths

    server = paths.serving_path("cadrl4", cuda_device).server(
        num_envs=256, steps_per_dispatch=1, device=cuda_device)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    server.dispatch()
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["cadrl_lookahead"] == before["cadrl_lookahead"] + 1
    assert after["cadrl_value"] == before["cadrl_value"] + 1


def test_kernel_constants_are_the_plain_tables():
    """The candidate tables that the source writes out as doubles are the
    plain version's (``_TABLES``), to the last bit."""
    import re
    from pathlib import Path

    src = (Path(cadrl_lookahead.__file__).resolve().parent.parent / "csrc"
           / "cadrl_lookahead.cu").read_text()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return [float(v) for v in body.replace("\n", " ").split(",")]

    assert table("kNearOffsets") == [float(v) for v in cadrl_policy._TABLES["near_offsets"]]
    assert table("kNearScales") == cadrl_policy._TABLES["near_scales"]
    assert table("kDesiredScales") == cadrl_policy._TABLES["desired_scales"]
    assert float(re.search(r"kPi = ([0-9.]+);", src).group(1)) == math.pi
    assert float(re.search(r"kTwoPi = ([0-9.]+);", src).group(1)) == 2 * math.pi
