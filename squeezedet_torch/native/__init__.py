"""Native (C++) components and their build: the KITTI evaluator binary
and the batch image loader (``dataloader.py``).

Each source is compiled by ``g++`` into ``squeezedet_torch/_build/`` at
first use, keyed by a hash of its source and flags (as ``ops/_cuda.py``
keys the kernels), so an edited source rebuilds and a concurrent build
never leaves half a file where a caller looks.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parent.parent
KITTI_EVAL_SOURCE = _PKG / "native" / "kitti_eval" / "evaluate_object.cc"
BUILD = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")

_LOCK = threading.Lock()


def hashed_path(source: Path, stem: str, flags: Sequence[str],
                suffix: str = "") -> Path:
    """``_build/<stem>-<hash><suffix>``, the hash over the source and the
    compiler flags."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD / "{}-{}{}".format(stem, digest[:16], suffix)


def compile_cached(source: Path, output: Path, flags: Sequence[str],
                   libs: Sequence[str] = ()) -> str:
    """Compile ``source`` into ``output`` unless it exists; returns its
    path.  The compiler writes a name of its own, renamed into place
    atomically.  Raises ``RuntimeError`` when no C++ compiler is found or
    the build fails, with the compiler's output."""
    with _LOCK:
        if output.exists():
            return str(output)
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError("no C++ compiler (g++) on PATH")
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = output.with_name(output.name + ".{}.tmp".format(os.getpid()))
        cmd = [cxx, *flags, "-o", str(tmp), str(source), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("{} failed:\n{}{}".format(
                " ".join(cmd), proc.stdout, proc.stderr))
        os.replace(tmp, output)  # atomic: a concurrent caller never runs half
        return str(output)


def kitti_eval_path() -> Path:
    """The cached evaluator binary for the current source and flags."""
    return hashed_path(KITTI_EVAL_SOURCE, "evaluate_object", CXX_FLAGS)


def build_kitti_eval() -> str:
    """Compile the evaluator unless its hashed binary exists; returns its
    path.  Raises ``RuntimeError`` when no C++ compiler is found or the
    build fails."""
    return compile_cached(KITTI_EVAL_SOURCE, kitti_eval_path(), CXX_FLAGS)
