"""Adam behind a global-norm clip, in optax's order of operations: the port's
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``
(optax 0.2.6, ``transforms/_clipping.py`` and ``_src/transform.py``).

Plain functions over a ``{name: tensor}`` dict of parameters, whose order is
the order of the global norm's sum (the JAX package's sorted names).  The
state is a dict of tensors, ``{"count": int32 0-dim, "mu": {...}, "nu":
{...}}``, so ``utils.checkpoint`` saves it.  The step count lives on the
host: the bias corrections ``1 - b ** count`` are float32 (float64 for
float64 parameters) powers computed there, as XLA computes them, and reach
the device as 0-dim tensors (a quotient by a host scalar would become a
reciprocal product on CUDA).

Neither ``torch.nn.utils.clip_grad_norm_`` (it scales by
``max_norm / (norm + 1e-6)``) nor ``torch.optim.Adam`` (``sqrt(v) / sqrt(bc2)``
and its bias corrections in host float64) computes the same function.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from gym_collision_avoidance_torch.core.maths import sqrt_rn

B1, B2, EPS = 0.9, 0.999, 1e-8
_INT32_MAX = 2**31 - 1


def init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero moments beside each parameter and a zero step count."""
    return {"count": torch.zeros((), dtype=torch.int32),
            "mu": {k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()}}


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt`` of the sum, in the dict's order, of each tensor's sum of
    squares (``optax.global_norm``)."""
    total = None
    for g in grads.values():
        s = torch.sum(g * g)
        total = s if total is None else total + s
    return sqrt_rn(total)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    """``g`` where the global norm is below ``max_norm``, else
    ``(g / norm) * max_norm``."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for k, g in grads.items()}


def _bias_correction(decay: float, count: int, dtype: torch.dtype, device) -> torch.Tensor:
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    value = np_dtype(1) - np_dtype(decay) ** np_dtype(count)
    return torch.tensor(value, dtype=dtype, device=device)


def update(grads: Mapping[str, torch.Tensor], state: dict, max_norm: float,
           lr: float) -> Tuple[Dict[str, torch.Tensor], dict]:
    """One step of the chain: the updates to add to the parameters, and the
    next state.  ``grads`` has the parameters' names and order."""
    return adam(clip_by_global_norm(grads, max_norm), state, lr)


def adam(grads: Mapping[str, torch.Tensor], state: dict,
         lr: float) -> Tuple[Dict[str, torch.Tensor], dict]:
    """The chain's second link, ``optax.adam(lr)``, on already clipped
    ``grads``: the updates and the next state."""
    count = int(state["count"])
    count = count + 1 if count < _INT32_MAX else count          # optax.safe_increment
    first = next(iter(grads.values()))
    bc1 = _bias_correction(B1, count, first.dtype, first.device)
    bc2 = _bias_correction(B2, count, first.dtype, first.device)
    mu, nu, updates = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - B1) * g + B1 * state["mu"][k]
        nu[k] = (1 - B2) * (g * g) + B2 * state["nu"][k]
        mu_hat, nu_hat = mu[k] / bc1, nu[k] / bc2
        updates[k] = mu_hat / (sqrt_rn(nu_hat) + EPS) * -lr
    return updates, {"count": torch.tensor(count, dtype=torch.int32), "mu": mu, "nu": nu}


def apply_updates(params: Mapping[str, torch.Tensor], updates: Mapping[str, torch.Tensor]):
    """``p + u`` into each parameter, in place (``optax.apply_updates``)."""
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])
