"""ctypes binding of the native batch image loader (``--native_loader``;
counterpart of ``squeezedet_tpu/native/dataloader.py``, same C ABI).

``dataloader/loader.cc`` decodes each frame, subtracts the BGR means,
applies the drift crop and flip that the caller drew, and resizes
bilinearly, on a pool of C++ threads that run without the GIL.  It needs
only zlib: its PNG decoder transcribes ``data/png.py`` and its resize is
``cv2.resize``'s INTER_LINEAR, so it serves PNG frames (KITTI's) and
refuses any other format.  Its pixels match the Python reader's within
half an f32 ulp of the mean subtraction (the Python reader subtracts
float64 means, the library float32 ones) plus the resize's summation
order.

The library is built by ``g++`` at first use into
``squeezedet_torch/_build/libsdloader-<hash>.so`` (``native.
compile_cached``).  Nothing falls back: a library that cannot build
raises, naming the compiler's error.  ``BATCHES`` counts the batches the
library has loaded.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence, Tuple

import numpy as np

from squeezedet_torch import native

SOURCE = native._PKG / "native" / "dataloader" / "loader.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared",
             "-pthread")
LIBS = ("-lz",)
# a failed image's status (loader.cc Status), marked in its scale row
_FAILURES = {1: "cannot be read", 2: "has no pixels left after its drift",
             3: "is not a PNG the loader decodes (non-interlaced 8-bit "
                "gray, RGB or RGBA)"}

BATCHES = 0  # batches the library loaded
_count_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()


def library_path():
    """The cached library for the current source and flags."""
    return native.hashed_path(SOURCE, "libsdloader", CXX_FLAGS + LIBS, ".so")


def load():
    """The library, built at the first call; raises ``RuntimeError`` when
    it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            path = native.compile_cached(SOURCE, library_path(), CXX_FLAGS,
                                         LIBS)
        except RuntimeError as e:
            raise RuntimeError("the native loader needs g++ and zlib's "
                               "header and library: {}".format(e)) from e
        lib = ctypes.CDLL(path)
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.sdl_load_image_batch.restype = ctypes.c_int
        lib.sdl_load_image_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, fptr, ctypes.c_int, fptr, fptr]
        lib.sdl_load_train_batch.restype = ctypes.c_int
        lib.sdl_load_train_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, fptr, fptr, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, fptr, fptr]
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _call(fn, paths: Sequence[str], out_w: int, out_h: int, bgr_means,
          *extra) -> Tuple[np.ndarray, np.ndarray]:
    global BATCHES
    n = len(paths)
    if n < 1 or out_w < 1 or out_h < 1:
        raise ValueError("a batch needs images and a positive size, got {} "
                         "images at {}x{}".format(n, out_w, out_h))
    images = np.empty((n, out_h, out_w, 3), np.float32)
    scales = np.empty((n, 2), np.float32)
    means = np.ascontiguousarray(np.asarray(bgr_means, np.float32)
                                 .reshape(3))
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = fn(names, n, out_w, out_h, _fptr(means), *extra, _fptr(images),
            _fptr(scales))
    if rc != 0:
        failed = ["{} {}".format(paths[i], _FAILURES.get(int(-scales[i, 0]),
                                                         "failed"))
                  for i in range(n) if scales[i, 0] < 0]
        raise IOError("native loader: {}".format("; ".join(failed)))
    with _count_lock:
        BATCHES += 1
    return images, scales


def load_image_batch(paths: Sequence[str], out_w: int, out_h: int,
                     bgr_means, num_threads: int = 4
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Eval reader batch: (images [N, H, W, 3] f32 mean-subtracted at
    ``out_h`` x ``out_w``, scales [N, 2] (x_scale, y_scale))."""
    return _call(load().sdl_load_image_batch, paths, out_w, out_h, bgr_means,
                 num_threads)


def load_train_batch(paths: Sequence[str], out_w: int, out_h: int,
                     bgr_means, drift, flip, num_threads: int = 4
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Train reader batch with each image's (dx, dy) drift and flip flag
    drawn by the caller; returns (images, scales) as
    :func:`load_image_batch`, the scales relative to the drifted size."""
    n = len(paths)
    drift = np.ascontiguousarray(np.asarray(drift, np.float32).reshape(n, 2))
    flip = np.ascontiguousarray(np.asarray(flip, np.uint8).reshape(n))
    return _call(load().sdl_load_train_batch, paths, out_w, out_h, bgr_means,
                 _fptr(drift), flip.ctypes.data_as(
                     ctypes.POINTER(ctypes.c_ubyte)), num_threads)
