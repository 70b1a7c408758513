"""Native (C++) components: the KITTI evaluator binary and its build.

``kitti_eval/evaluate_object.cc`` is compiled by ``g++ -O2 -std=c++17``
into ``squeezedet_torch/_build/`` at first use, keyed by a hash of its
source and flags (as ``ops/_cuda.py`` keys the kernels), so an edited
source rebuilds and a concurrent build never runs half a file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
KITTI_EVAL_SOURCE = _PKG / "native" / "kitti_eval" / "evaluate_object.cc"
BUILD = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")

_LOCK = threading.Lock()


def kitti_eval_path() -> Path:
    """The cached evaluator binary for the current source and flags."""
    digest = hashlib.sha256(KITTI_EVAL_SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD / "evaluate_object-{}".format(digest[:16])


def build_kitti_eval() -> str:
    """Compile the evaluator unless its hashed binary exists; returns its
    path.  Raises ``RuntimeError`` when no C++ compiler is found or the
    build fails."""
    binary = kitti_eval_path()
    with _LOCK:
        if binary.exists():
            return str(binary)
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError("no C++ compiler (g++) on PATH")
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = binary.with_name(binary.name + ".{}.tmp".format(os.getpid()))
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(KITTI_EVAL_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("{} failed:\n{}{}".format(
                " ".join(cmd), proc.stdout, proc.stderr))
        os.replace(tmp, binary)  # atomic: a concurrent caller never runs half
        return str(binary)
