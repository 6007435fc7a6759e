"""Build, load, launch and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/lib<name>-<hash>.so`` inside the package (a directory that
``.gitignore`` lists) at first use, then loaded with ``ctypes``.  The hash
covers the source and the flags, so an edited source is rebuilt.  A kernel
wrapper declares each C entry once as a :class:`Kernel`, which launches it
on the current stream, checks what the launch returns and counts it under
its source's name (:func:`launch_counts`).  Nothing is built at import time:
the CPU tests import every module without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

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

# every source of csrc/, by name
SOURCES = tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))
# each source's launches on the card since import (or since zero_launch_counts)
_COUNTS: Dict[str, int] = dict.fromkeys(SOURCES, 0)
# the symbol suffix of a C entry's version for each dtype
_SUFFIXES = {torch.float32: "_f32", torch.float64: "_f64"}


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


def launch_counts() -> Dict[str, int]:
    """``{source: launches}`` of every source of ``csrc/``: the launches
    on the card (never a plain version's calls on the CPU)."""
    return dict(_COUNTS)


def zero_launch_counts() -> None:
    """Set every source's launch count to 0."""
    for name in _COUNTS:
        _COUNTS[name] = 0


class Kernel:
    """The C entry ``<entry>_f32`` / ``<entry>_f64`` of ``csrc/<source>.cu``,
    whose ``argtypes`` are followed by the ``cudaStream_t`` it launches on
    and which returns a ``cudaError_t``.

    ``kernel(dtype, *args, device=...)`` launches the entry for ``dtype``
    on ``device``'s current stream (no synchronise), raises ``RuntimeError``
    on a launch error and counts one launch under ``source``.  The library
    is built and loaded at the first launch of each dtype."""

    def __init__(self, source: str, entry: str, argtypes):
        self.source, self.entry, self.argtypes = source, entry, list(argtypes)
        self.symbols = {dtype: entry + suffix for dtype, suffix in _SUFFIXES.items()}
        self.funcs = {}    # dtype -> the loaded entry

    def check(self, dtype) -> None:
        """Raise ``TypeError`` unless the entry has a version for ``dtype``
        (nothing is built)."""
        if dtype not in self.symbols:
            names = " or ".join(str(d).removeprefix("torch.") for d in self.symbols)
            raise TypeError(f"the {self.entry} kernel takes {names}, not {dtype}")

    def func(self, dtype):
        """The loaded entry for ``dtype`` (built and loaded at first use)."""
        fn = self.funcs.get(dtype)
        if fn is None:
            self.check(dtype)
            fn = getattr(load(self.source), self.symbols[dtype])
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.funcs[dtype] = fn
        return fn

    def __call__(self, dtype, *args, device) -> None:
        err = self.func(dtype)(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.entry} kernel launch failed: cudaError {err}")
        _COUNTS[self.source] += 1


def check_launch_args(fields, device) -> None:
    """Raise unless every ``(name, tensor, dtype, shape)`` of ``fields`` is a
    contiguous tensor of that dtype and shape on ``device``, and ``device``
    is the current CUDA device (a launcher runs there)."""
    for name, t, dtype, shape in fields:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"tensors are on {device}; the kernels run on a CUDA device")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
