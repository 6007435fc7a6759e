"""The port's other-agents sensor against the JAX package's, vmapped over
envs: all three sort modes, ties in the round(d, 2) key, a finite sensing
horizon and invalid agents.  Slot rows, ``closest`` and counts must be in
the same order; values agree to atol 1e-12 in float64 (the same formulas,
torch and XLA round a few operations differently)."""

import jax
import numpy as np
import pytest

import _torch_parity as tp
from gym_collision_avoidance_torch.config import EnvConfig as TCfg
from gym_collision_avoidance_torch.obs import sensors as tsensors
from gym_collision_avoidance_tpu.config import EnvConfig as JCfg
from gym_collision_avoidance_tpu.obs import sensors as jsensors


def _state(seed, E=24, A=6):
    rng = np.random.RandomState(seed)
    # positions on a 0.25 grid and radii from two values make many exact
    # ties in round(d, 2) and in p_orth, so the index tie-break matters
    pos = rng.randint(-8, 9, (E, A, 2)) * 0.25
    goal = rng.uniform(-4, 4, (E, A, 2))
    radius = rng.choice([0.25, 0.5], (E, A))
    pref = rng.uniform(0.5, 1.5, (E, A))
    valid = rng.rand(E, A) > 0.15
    cfg = JCfg(dtype="float64")
    leaves = tp.jax_leaves(tp.jax_batched_init(cfg, pos, goal, radius, pref, valid=valid))
    leaves["vel"] = rng.uniform(-1, 1, (E, A, 2))
    # a previous closest-agent cache that hosts with nobody visible keep
    leaves["other_agent_states"] = rng.uniform(-1, 1, (E, A, 7))
    return leaves


@pytest.mark.parametrize("method", ["closest_first", "closest_last", "time_to_impact"])
@pytest.mark.parametrize("horizon", [np.inf, 1.6])
def test_other_agents_states_match(method, horizon):
    leaves = _state(11)
    kw = dict(dtype="float64", agent_sorting_method=method, sensing_horizon=horizon)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    ref = jax.jit(jax.vmap(lambda s: jsensors.other_agents_states(s, jcfg)))(
        tp.jax_state(leaves))
    got = tsensors.other_agents_states(
        tp.convert.state_from_numpy(leaves, device=tp.DEVICE), tcfg)
    names = ("rows", "closest", "counts")
    tp.assert_tree_close(dict(zip(names, got)), dict(zip(names, ref)),
                         rtol=0, atol=1e-12)
    counts = np.asarray(ref[2])
    if horizon < np.inf:
        # the horizon leaves some hosts seeing nobody: closest keeps its cache
        assert (counts == 0).any()
        np.testing.assert_array_equal(np.asarray(got[1])[counts == 0],
                                      leaves["other_agent_states"][counts == 0])
    assert (counts == 3).any()


def test_rank_ties_break_by_index():
    import torch

    keys = (torch.tensor([[0.5, 0.5, 0.25, 0.5]]), torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    idx = torch.arange(4)
    rank = tsensors._lex_rank_masked(keys, idx, torch.ones(1, 4, dtype=torch.bool))
    # np.lexsort order of (primary 0.5,0.5,0.25,0.5; secondary 1,0,0,0)
    order = np.lexsort((keys[1][0].numpy(), keys[0][0].numpy()))
    np.testing.assert_array_equal(rank[0].numpy()[order], np.arange(4))
