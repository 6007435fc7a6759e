"""Checkpoint and resume of nested training carries (port of
:mod:`gym_collision_avoidance_tpu.utils.checkpoint`).

A carry is any nesting of tuples, lists, dicts, :class:`EnvState`,
``nn.Module`` (its ``state_dict``), ``torch.Generator`` (its state) and
tensors: the PPO trainer saves ``(params, opt_state, states, counters, obs)``
and its generator through it for a bitwise resume.  The file is an ``.npz`` of
the leaves beside a structure record (every leaf's path, container types,
dtype and shape), which must equal the record of the ``like`` carry on load,
as the JAX version checks its treedef: a carry of another structure would
otherwise take leaves of compatible shapes in the wrong places.
"""

from __future__ import annotations

import copy
import os
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from gym_collision_avoidance_torch.core.state import EnvState

_RECORD = "__structure__"


def _flatten(tree, path: str, leaves: List[np.ndarray], record: List[str]):
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach().cpu().numpy())
        record.append(f"{path}: {str(tree.dtype)[6:]}{list(tree.shape)}")
    elif isinstance(tree, torch.Generator):
        leaves.append(tree.get_state().numpy())
        record.append(f"{path}: Generator({tree.device.type})")
    elif isinstance(tree, nn.Module):
        for k, v in tree.state_dict(keep_vars=True).items():
            _flatten(v, f"{path}<{type(tree).__name__}>.{k}", leaves, record)
    elif isinstance(tree, EnvState):
        for k, v in tree.items():
            _flatten(v, f"{path}<EnvState>.{k}", leaves, record)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{path}{{{k}}}", leaves, record)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}<{type(tree).__name__}>[{i}]", leaves, record)
    else:
        raise TypeError(f"cannot checkpoint {type(tree).__name__} at {path or 'the root'}")


def structure(tree) -> Tuple[List[np.ndarray], str]:
    """``(leaves as numpy arrays, structure record)`` of a carry."""
    leaves, record = [], []
    _flatten(tree, "", leaves, record)
    return leaves, "\n".join(record)


def _rebuild(like, it):
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(next(it), dtype=like.dtype, device=like.device)
    if isinstance(like, torch.Generator):
        gen = torch.Generator(like.device)
        gen.set_state(torch.as_tensor(next(it)))
        return gen
    if isinstance(like, nn.Module):
        module = copy.deepcopy(like)
        with torch.no_grad():
            for v in module.state_dict(keep_vars=True).values():
                v.copy_(torch.as_tensor(next(it)))
        return module
    if isinstance(like, EnvState):
        return EnvState(**{k: _rebuild(v, it) for k, v in like.items()})
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    return type(like)(_rebuild(v, it) for v in like)


def save_state(path: str, tree) -> str:
    """Write the carry ``tree`` to an ``.npz`` at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, record = structure(tree)
    np.savez(path, **{_RECORD: np.frombuffer(record.encode(), dtype=np.uint8)},
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    return path


def load_state(path: str, like):
    """Restore a carry saved by :func:`save_state`, with the structure of
    ``like`` and each leaf on the device of ``like``'s; ``like`` is not
    changed.  Raises ``ValueError`` if the saved structure differs."""
    _, expected = structure(like)
    with np.load(path) as z:
        saved = bytes(z[_RECORD]).decode()
        if saved != expected:
            raise ValueError(f"checkpoint {path!r} was saved with another structure:\n"
                             f"  saved:\n{saved}\n  expected:\n{expected}")
        n = sum(k.startswith("leaf_") for k in z.files)
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    return _rebuild(like, iter(leaves))
