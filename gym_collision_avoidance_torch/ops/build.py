"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/lib<name>-<hash>.so`` inside the package (a directory that
``.gitignore`` lists) at first use, then loaded with ``ctypes``.  The hash
covers the source and the flags, so an edited source is rebuilt.  Nothing
here runs at import time: the CPU tests import every module without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

# --fmad=false and no --use_fast_math: the kernels' exactness rules (see
# the note at the top of each source).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def check_launch_args(fields, device) -> None:
    """Raise unless every ``(name, tensor, dtype, shape)`` of ``fields`` is a
    contiguous tensor of that dtype and shape on ``device``, and ``device``
    is the current CUDA device (a launcher runs there)."""
    import torch

    for name, t, dtype, shape in fields:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
