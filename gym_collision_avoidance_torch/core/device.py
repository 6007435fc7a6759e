"""Device selection for the port's entry points.

Entry points take ``device=None``, which means the CUDA card.  There is no
silent fallback: without CUDA the default raises, and a caller who wants the
CPU (the tests) says so.
"""

from __future__ import annotations

import copy
import subprocess

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent.

    On the card this also turns TF32 off for matmuls and cuDNN, the GPU's
    counterpart of the TPU's silent bf16 operand rounding, and makes cuDNN
    pick deterministic algorithms without benchmarking, so that serving and
    training run under one cuDNN configuration and two runs of one seed
    give the same bits (the trainer's backward convolutions included).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return device


def torch_dtype(name: str) -> torch.dtype:
    """``EnvConfig.dtype`` string -> torch dtype."""
    return {"float32": torch.float32, "float64": torch.float64}[name]


def params_to_device(params, device):
    """A copy of a policy ``params`` dict on ``device``: modules (the
    GA3C-CADRL weights) are copied there, so the caller's stays where it
    was; tensors move and numpy arrays become tensors there; other values
    stay."""
    if params is None:
        return None
    out = {}
    for key, value in params.items():
        if isinstance(value, torch.nn.Module):
            value = copy.deepcopy(value).to(device)
        elif isinstance(value, (torch.Tensor, np.ndarray)):
            value = torch.as_tensor(value, device=device)
        out[key] = value
    return out


def as_device_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a ``dtype`` tensor on ``device``; no
    copy when it is one already, so a caller that moves its inputs once
    keeps the card's queue free of host copies."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=dtype,
                           device=device)


def card_label(device) -> str:
    """``nvidia-smi``'s name and power limit of ``device``'s card (``name,
    power.limit``), or ``cpu``: what a measurement names beside its numbers."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()
