"""The PPO trainer on the card.

Imports neither JAX nor ``tests/conftest.py``'s setup, so it runs on a
machine with a CUDA card and no JAX::

    python -m pytest --noconftest -q -s tests/test_torch_train_cuda.py

Without a card every case skips.  Each training path of
``harness/paths.py`` at E = 64 envs and T = 8 steps, at its full net width:

* one minibatch's gradients on the card with TF32 off within 1e-4 of each
  tensor's largest CPU entry (cuBLAS and cuDNN sum in other orders than
  the CPU); with TF32 on, how far they move is printed, not held;
* two iterations from one seed, twice, give the same bits (``core.device``
  sets cuDNN deterministic for the whole package; the policy's one-hot
  log-prob has no atomic backward);
* K2 takes train_drl2's empty static-cell list and equals its plain
  version bitwise.
"""

import copy

import numpy as np
import pytest
import torch

from gym_collision_avoidance_torch.harness import paths
from gym_collision_avoidance_torch.ops import raymarch
from gym_collision_avoidance_torch.train.ppo import compute_gae, trainable_params
from gym_collision_avoidance_torch.utils import checkpoint as ckpt


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _small(name):
    return paths.training_path(name).resized(64, 8)


def _minibatch(path):
    """A CPU rollout of ``path`` and its first minibatch of samples."""
    trainer = path.trainer("cpu")
    carry = path.init(trainer)
    noise = trainer.sample_noise(torch.Generator().manual_seed(3))
    data = trainer.rollout(carry[0], *carry[2:], noise)[3]
    adv, target = compute_gae(data["reward"], data["value"], data["done"], data["last_value"],
                              path.ppo.gamma, path.ppo.gae_lambda)
    n = path.ppo.mb_envs * path.ppo.horizon
    flat = {"x": data["x"], "act": data["act"], "logp": data["logp"], "adv": adv,
            "target": target, "alive": data["alive"]}
    batch = {k: v.transpose(0, 1).reshape((-1,) + v.shape[2:])[:n] for k, v in flat.items()}
    return trainer, carry[0], batch


def _grads(trainer, params, batch):
    loss, _ = trainer.loss_fn(params, batch)
    named = trainable_params(params)
    return dict(zip(named, (g.cpu() for g in torch.autograd.grad(loss, list(named.values())))))


@pytest.mark.cuda
@pytest.mark.parametrize("name", paths.TRAIN_PATHS)
def test_gradients_on_the_card_with_tf32_off_and_on(cuda_device, name):
    trainer, params, batch = _minibatch(_small(name))
    want = _grads(trainer, params, batch)
    card_params = copy.deepcopy(params).to(cuda_device)
    card_batch = {k: v.to(cuda_device) for k, v in batch.items()}
    got = _grads(trainer, card_params, card_batch)
    for k, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        tf32 = _grads(trainer, card_params, card_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    moved = {k: float((tf32[k] - w).abs().max() / max(float(w.abs().max()), 1e-30))
             for k, w in want.items()}
    off = {k: float((got[k] - w).abs().max() / max(float(w.abs().max()), 1e-30))
           for k, w in want.items()}
    print(f"\n{name}: largest gradient change relative to its tensor's max, "
          f"TF32 off {max(off.values()):.3g} ({max(off, key=off.get)}), "
          f"TF32 on {max(moved.values()):.3g} ({max(moved, key=moved.get)})")


@pytest.mark.cuda
@pytest.mark.parametrize("name", paths.TRAIN_PATHS)
def test_two_iterations_are_bitwise_equal_to_themselves(cuda_device, name):
    path = _small(name)
    trainer = path.trainer(cuda_device)
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    runs = []
    for _ in range(2):
        carry = path.init(trainer)
        gen = torch.Generator(cuda_device).manual_seed(11)
        for _ in range(2):
            *carry, _m = trainer.train_step(*carry, rng=gen)
        runs.append(ckpt.structure(tuple(carry)))
    (a, rec_a), (b, rec_b) = runs
    assert rec_a == rec_b
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_k2_takes_an_empty_static_cell_list(cuda_device):
    path = _small("train_drl2")
    trainer = path.trainer(cuda_device)
    params, _, states, counters, obs = path.init(trainer)
    noise = trainer.sample_noise(torch.Generator(cuda_device).manual_seed(5))
    calls, outs = [], []
    launch = raymarch.raymarch_cuda

    def spy(*args):
        calls.append(args)
        outs.append(launch(*args))
        return outs[-1]

    raymarch.raymarch_cuda = spy
    try:
        trainer.rollout(params, states, counters, obs, noise)
    finally:
        raymarch.raymarch_cuda = launch
    torch.cuda.synchronize()
    assert len(calls) == path.ppo.horizon
    for args, out in zip(calls, outs):
        assert args[9].shape == (0, 2) and args[9].is_cuda
        ref = raymarch.raymarch_plain(*args)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
