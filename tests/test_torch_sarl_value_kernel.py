"""SARL's value-net kernel (``ops/sarl_value.py``, ``csrc/sarl_value.cu``) on
the CPU: what surrounds the launch.

A CPU tensor takes the plain version and launches nothing; the packed
weights the kernel reads put every weight at the offset the source's note
gives (the sizes tied to the source's constants), are packed once, and again
after any change of a weight; the wrapper raises before any build on a net
of other widths, a dtype it does not take, inputs of other shapes or not
contiguous and more others than a tile holds; the present mask reaches the
kernel as the rows that the candidates share, without a copy on the
policy's path; and the SARL policy reaches the net only through
``models.sarl.forward_raw`` (the name the benchmark's recorder wraps) with
inputs the wrapper takes.  The kernel itself is held against the plain
version on the card by ``tests/test_torch_sarl_cuda.py``.
"""

import copy
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch import ops
from gym_collision_avoidance_torch.harness import paths
from gym_collision_avoidance_torch.models import sarl
from gym_collision_avoidance_torch.ops import build, sarl_value
from gym_collision_avoidance_torch.policies import sarl as sarl_policy

SOURCE = (Path(__file__).resolve().parent.parent / "gym_collision_avoidance_torch" / "csrc"
          / "sarl_value.cu").read_text()
# each piece's first element in the packed buffer
OFFSETS = dict(zip((name for name, _, _ in sarl_value.LAYOUT),
                   itertools.accumulate((size for _, size, _ in sarl_value.LAYOUT), initial=0)))


def _inputs(dtype, lead=(2, 3, 4), P=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    pairs = torch.randn(*lead, P, 13, generator=g, dtype=torch.float64).to(dtype)
    self_state = torch.randn(*lead, 6, generator=g, dtype=torch.float64).to(dtype)
    present = torch.rand(*lead[:-1], 1, P, generator=g) < 0.7
    return pairs, present, self_state


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensor_takes_the_plain_version(dtype):
    before = ops.launch_counts()["sarl_value"]
    net = sarl.load_params(dtype=dtype, device="cpu")
    inputs = _inputs(dtype)
    got = sarl.forward_raw(net, *inputs)
    assert got.shape == (2, 3, 4) and got.dtype == dtype
    assert torch.equal(got, sarl.forward_raw_plain(net, *inputs))
    assert ops.launch_counts()["sarl_value"] == before
    with pytest.raises(ValueError, match="no SARL value net"):
        sarl.forward_raw(net, *(t.to("meta") for t in inputs))


def _layers(net):
    return {name: dict(weight=layer.weight, bias=layer.bias)
            for name, layer in ((f"{stack}.{i}", getattr(net, stack)[int(i)])
                                for stack, i in (n.split(".") for n in sarl_value.WIDTHS))}


def _grouped(piece, K, cols, pad, at=0):
    """Columns ``cols`` a group, starting ``at`` into each group, of a
    ``[K][8][pad]`` piece: the ``[K, 8 cols]`` matrix they hold."""
    return piece.reshape(K, 8, pad)[:, :, at:at + cols].reshape(K, 8 * cols)


def test_the_layout_matches_the_source():
    sizes = dict((name, size) for name, size, _ in sarl_value.LAYOUT)
    streamed = ("W12", "W21|Wa|Wb", "W22|W_a2", "W30", "W31", "W32")
    assert list(sizes)[:len(streamed)] == list(streamed)
    assert sum(sizes[n] for n in streamed) == int(
        re.search(r"kStreamSize == (\d+)", SOURCE).group(1)) == 108560
    assert sum(sizes.values()) - sum(sizes[n] for n in streamed) == int(
        re.search(r"kResSize == (\d+)", SOURCE).group(1)) == 3244
    assert all(size % 4 == 0 for size in sizes.values())
    # the offsets the source note lists piece by piece
    assert OFFSETS == {
        "W12": 0, "W21|Wa|Wb": 19200, "W22|W_a2": 51600, "W30": 67600, "W31": 76560,
        "W32": 95760, "W11": 108560, "b11": 110640, "b12": 110792, "b21": 110892,
        "b22": 110992, "b_a1": 111044, "b_a2": 111144, "w_a3": 111244, "b_a3": 111344,
        "b30": 111348, "b31": 111500, "b32": 111600, "w33": 111700, "b33": 111800}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_puts_each_weight_at_its_offset(dtype):
    net = sarl.load_params(dtype=dtype, device="cpu")
    packed = sarl_value.packed(net)
    assert packed.dtype == dtype and packed.numel() == 111804
    L = _layers(net)
    W = {name: layer["weight"].T for name, layer in L.items()}   # [in, out]

    def piece(name):
        at = OFFSETS[name]
        size = dict((n, s) for n, s, _ in sarl_value.LAYOUT)[name]
        return packed[at:at + size]

    def padded(w, width):
        return torch.nn.functional.pad(w, (0, width - w.shape[1]))

    assert torch.equal(_grouped(piece("W12"), 150, 13, 16), padded(W["mlp1.2"], 104))
    both = piece("W21|Wa|Wb").reshape(100, 324)
    assert torch.equal(_grouped(both[:, :224].reshape(-1), 100, 25, 28),
                       torch.cat([W["mlp2.0"], W["attention.0"][:100]], dim=1))
    assert torch.equal(both[:, 224:], W["attention.0"][100:])
    dual = piece("W22|W_a2")
    assert torch.equal(_grouped(dual, 100, 7, 20), padded(W["mlp2.2"], 56))
    assert torch.equal(_grouped(dual, 100, 13, 20, at=7), padded(W["attention.2"], 104))
    assert torch.equal(_grouped(piece("W30"), 56, 19, 20), padded(W["mlp3.0"], 152))
    assert torch.equal(_grouped(piece("W31"), 150, 13, 16), padded(W["mlp3.2"], 104))
    assert torch.equal(_grouped(piece("W32"), 100, 13, 16), padded(W["mlp3.4"], 104))
    assert torch.equal(_grouped(piece("W11"), 13, 19, 20), padded(W["mlp1.0"], 152))
    vectors = {"b11": L["mlp1.0"]["bias"], "b12": L["mlp1.2"]["bias"],
               "b21": L["mlp2.0"]["bias"], "b22": L["mlp2.2"]["bias"],
               "b_a1": L["attention.0"]["bias"], "b_a2": L["attention.2"]["bias"],
               "w_a3": L["attention.4"]["weight"][0], "b_a3": L["attention.4"]["bias"],
               "b30": L["mlp3.0"]["bias"], "b31": L["mlp3.2"]["bias"],
               "b32": L["mlp3.4"]["bias"], "w33": L["mlp3.6"]["weight"][0],
               "b33": L["mlp3.6"]["bias"]}
    for name, v in vectors.items():
        got = piece(name)
        assert torch.equal(got[:v.numel()], v) and not got[v.numel():].any(), name
    # W12's row 3, columns 13-25, by hand: group 1 starts 16 elements into the row
    assert torch.equal(packed[3 * 128 + 16:3 * 128 + 29], W["mlp1.2"][3, 13:26])


def _follows(net):
    assert torch.equal(sarl_value.packed(net), sarl_value.pack(net.state_dict()))


def test_packed_weights_follow_the_state_dict():
    net = sarl.load_params(device="cpu")
    other = sarl.init_params(seed=7, device="cpu")
    first = sarl_value.packed(net)
    assert sarl_value.packed(net) is first
    net.load_state_dict(other.state_dict())
    assert torch.equal(sarl_value.packed(net), sarl_value.packed(other))
    for p in net.parameters():
        p.data = p.data.to(torch.bfloat16).to(p.dtype)
    assert not torch.equal(sarl_value.packed(net), sarl_value.packed(other))
    _follows(net)
    with torch.no_grad():
        net.mlp3[6].bias.add_(1.0)
        net.attention[0].weight[0, 150] = 7.0
    _follows(net)
    twin = copy.deepcopy(net)
    with torch.no_grad():
        twin.mlp1[0].weight.mul_(2.0)
    _follows(twin)
    _follows(net)
    assert sarl_value.packed(net.double()).dtype == torch.float64


@pytest.fixture
def no_build(monkeypatch):
    """Fail if anything would build or load a kernel library."""
    def refuse(*args, **kwargs):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)


def test_the_wrapper_raises_before_any_build(no_build):
    net = sarl.load_params(device="cpu")
    pairs, present, self_state = _inputs(torch.float32)
    wide = sarl.load_params(device="cpu")
    wide.mlp2[2] = torch.nn.Linear(100, 60)
    with pytest.raises(ValueError, match="mlp2.2 of 100 -> 50"):
        sarl_value.value_net_cuda(wide, pairs, present, self_state)
    with pytest.raises(TypeError, match="sarl_value kernel takes float32 or float64"):
        sarl_value.value_net_cuda(sarl.load_params(device="cpu").to(torch.bfloat16), pairs,
                                  present, self_state)
    with pytest.raises(TypeError, match="pairs must be torch.float32"):
        sarl_value.value_net_cuda(net, pairs.double(), present, self_state)
    with pytest.raises(TypeError, match="present must be torch.bool"):
        sarl_value.value_net_cuda(net, pairs, present.float(), self_state)
    with pytest.raises(ValueError, match="pairs must be contiguous"):
        sarl_value.value_net_cuda(net, pairs.transpose(0, 1).contiguous().transpose(0, 1),
                                  present, self_state)
    with pytest.raises(ValueError, match="self_state must be contiguous"):
        sarl_value.value_net_cuda(net, pairs, present,
                                  self_state.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="self_state must be"):
        sarl_value.value_net_cuda(net, pairs, present, self_state[..., :5])
    with pytest.raises(ValueError, match=r"pairs must be \[..., P, 13\]"):
        sarl_value.value_net_cuda(net, pairs[..., :12], present, self_state)
    many = _inputs(torch.float64, lead=(1, 2), P=65)
    with pytest.raises(ValueError, match="at most 64 others"):
        sarl_value.value_net_cuda(sarl.load_params(dtype="float64", device="cpu"), *many)
    # what passes every check stops at the device, still before a build
    with pytest.raises(ValueError, match="run on a CUDA device"):
        sarl_value.value_net_cuda(net, pairs, present, self_state)


def test_the_mask_reaches_the_kernel_as_shared_rows():
    present = torch.rand(3, 6, 1, 5) < 0.5
    rows, group = sarl_value.mask_rows(present, (3, 6, 81), 5)
    assert group == 81 and rows.shape == (18, 5) and rows.data_ptr() == present.data_ptr()
    assert torch.equal(rows.repeat_interleave(81, dim=0),
                       present.expand(3, 6, 81, 5).reshape(-1, 5))
    full = torch.rand(3, 6, 81, 5) < 0.5
    rows, group = sarl_value.mask_rows(full, (3, 6, 81), 5)
    assert group == 1 and rows.data_ptr() == full.data_ptr()
    # broadcast along a leading axis only: copied into rows of their own
    lead = torch.rand(1, 6, 81, 5) < 0.5
    rows, group = sarl_value.mask_rows(lead, (3, 6, 81), 5)
    assert group == 1 and torch.equal(rows, lead.expand(3, 6, 81, 5).reshape(-1, 5))
    rows, group = sarl_value.mask_rows(torch.tensor([True, False]), (), 2)
    assert group == 1 and rows.tolist() == [[True, False]]


def test_the_policy_reaches_the_net_through_forward_raw(monkeypatch):
    path = paths.serving_path("sarl6", "cpu")
    state, _ = paths.mid_episode_states(path, 3, 2, "cpu")
    calls = []
    plain = sarl.forward_raw_plain

    def recorded(net, pairs, present, self_state):
        calls.append((net, pairs.is_contiguous(), self_state.is_contiguous(), pairs.dtype,
                      present.dtype, tuple(pairs.shape), tuple(present.shape),
                      sarl_value.mask_rows(present, tuple(pairs.shape[:-2]), pairs.shape[-2])))
        return plain(net, pairs, present, self_state)

    def hidden(*args):
        raise AssertionError("the policy called the plain version by name")

    monkeypatch.setattr(sarl, "forward_raw", recorded)
    monkeypatch.setattr(sarl, "forward_raw_plain", hidden)
    sarl_policy.sarl_kernel(state, path.cfg, path.params)
    assert len(calls) == 1
    net, pairs_c, self_c, dtype, mask_dtype, shape, mask_shape, (rows, group) = calls[0]
    assert net is path.params["sarl"] and pairs_c and self_c and dtype == net.dtype
    assert mask_dtype == torch.bool and shape == (3, 6, 81, 5, 13) and mask_shape == (3, 6, 1, 5)
    assert group == 81 and rows.shape == (18, 5)
    assert np.prod(shape[:-2]) // group == rows.shape[0]
