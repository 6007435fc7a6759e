"""The bits of ``jax.random`` that the RVO policy draws, in plain PyTorch.

The env state carries the JAX PRNG key as ``[E, 2]`` int64 words (each a
uint32 value).  Threefry-2x32 (Salmon et al., SC 2011, 20 rounds) is computed
in int64 with every sum masked to 32 bits, so that CPU and CUDA give the
same bits as ``jax.random`` on the CPU: :func:`fold_in` is
``jax.random.fold_in`` and :func:`bernoulli` is ``jax.random.bernoulli`` on
a scalar, as JAX computes them with ``jax_threefry_partitionable`` on (its
default).  ``bernoulli`` draws 32 bits for a float32 ``p`` and 64 bits for a
float64 one, as JAX does for a ``p`` of that dtype.  Where JAX is given a
Python float, as the RVO kernel gives it, the width follows JAX's x64 mode
instead: 32 bits with it off, 64 with it on.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counts ``(x1, x2)`` under the key ``(k1, k2)``;
    int64 tensors (or ints) holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for r in range(5):
        for d in _ROTATIONS[r % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, d) ^ x1
        x1 = (x1 + ks[(r + 1) % 3]) & _MASK
        x2 = (x2 + ks[(r + 2) % 3] + (r + 1)) & _MASK
    return x1, x2


def key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` as ``[2]`` int64 key words: the high and
    the low 32 bits of ``seed``."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key, data):
    """``jax.random.fold_in``: ``key`` ``[..., 2]`` int64 words, ``data`` an
    integer tensor broadcast against ``key[..., 0]`` (taken modulo 2**32, as
    JAX casts it to uint32).  Returns ``[..., 2]`` key words."""
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, data.to(torch.int64) & _MASK)
    return torch.stack([y1, y2], dim=-1)


def bernoulli(key, p: float, dtype: torch.dtype):
    """``jax.random.bernoulli(key, p)`` for each ``[..., 2]`` key, with ``p``
    of ``dtype`` (float32: 32 random bits; float64: 64)."""
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, 0)
    if dtype == torch.float32:
        # uniform in [0, 1): the top 23 of the bits as the mantissa
        u = ((b1 ^ b2) >> 9).to(torch.float32) * 2.0 ** -23
    elif dtype == torch.float64:
        # the top 52 of the 64 bits (b1 << 32 | b2)
        u = ((b1 << 20) | (b2 >> 12)).to(torch.float64) * 2.0 ** -52
    else:
        raise ValueError(f"bernoulli draws for float32 or float64, not {dtype}")
    return u < p
