"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``squeezedet_torch/_build/`` at first use,
keyed by a hash of its source and flags, then loaded with ``ctypes``.
Nothing here runs at import: the package imports on machines with no
``nvcc`` and no GPU, and only a launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_FUNCTIONS: dict = {}
_LOCK = threading.Lock()
# nvcc's output (ptxas register/shared-memory report) of each build this
# process ran, by kernel name
BUILD_LOGS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found on PATH or at "
                           "/usr/local/cuda/bin/nvcc: cannot build the "
                           "CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """The cached .so for csrc/<name>.cu at its current source."""
    digest = hashlib.sha256((CSRC / (name + ".cu")).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / "lib{}-{}.so".format(name, digest[:16])


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its hashed .so already exists."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(so.name + ".{}.tmp".format(os.getpid()))
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / (name + ".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed ({}):\n{}{}".format(
            " ".join(cmd), proc.stdout, proc.stderr))
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    os.replace(tmp, so)  # atomic: a concurrent build never loads half a file
    return so


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.sdt_error_string.argtypes = [ctypes.c_int]
            lib.sdt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``symbol`` of csrc/<name>.cu, returning a cudaError_t,
    with its argument types set once per process (setting them costs
    microseconds on every call otherwise)."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch of csrc/<name>.cu returned a CUDA error."""
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            what, err, load(name).sdt_error_string(err).decode()))


def _counters():
    """The kernel wrappers' launch counts, as (module, attribute): each
    wrapper's ``LAUNCHES``, and K1's f32 route's share of its own."""
    from squeezedet_torch.ops import (anchor_match, bn_act, filter_grad,
                                      fused_frontend)
    return ((fused_frontend, "LAUNCHES"), (filter_grad, "LAUNCHES"),
            (fused_frontend, "F32_LAUNCHES"), (anchor_match, "LAUNCHES"),
            (bn_act, "LAUNCHES"))


class CapturedLaunches:
    """The kernels' launches held by a captured CUDA graph.

    A wrapper adds one to its ``LAUNCHES`` where it enqueues its kernel.
    Under stream capture that enqueue goes into the graph, and the kernel
    runs at each replay instead.  Entered around a capture, this records
    how many launches of each kernel the graph holds and takes them back
    off the counts (the capture ran nothing); :meth:`replayed` adds them
    once for each replay, so the counts stay launches that ran."""

    def __enter__(self) -> "CapturedLaunches":
        self._before = [getattr(m, a) for m, a in _counters()]
        self.per_replay = None
        return self

    def __exit__(self, *exc) -> bool:
        counters = _counters()
        self.per_replay = [getattr(m, a) - b
                           for (m, a), b in zip(counters, self._before)]
        for (m, a), b in zip(counters, self._before):
            setattr(m, a, b)
        return False

    def replayed(self) -> None:
        for (m, a), n in zip(_counters(), self.per_replay):
            setattr(m, a, getattr(m, a) + n)
