"""Filter gradient of a stride-1 SAME convolution (K2).

Counterpart of the Pallas kernel ``squeezedet_tpu/ops/filter_grad.py:
filter_grad``:

    dW[i, j, c, o] = sum_{b,y,x} X[b, y+i-ph, x+j-pw, c] * dY[b, y, x, o]

with X [B, H, W, C], dY [B, H, W, O] NHWC, odd kh and kw, X zero outside
the image, and dW [kh, kw, C, O] in f32.  On a CUDA tensor
:func:`filter_grad` launches the hand-written kernel in
``csrc/filter_grad.cu``; on a CPU tensor it runs
:func:`filter_grad_reference`, the plain PyTorch version.  Nothing falls
back: a CUDA tensor the kernel does not take raises.

The Pallas kernel's padded, guarded flat frames exist for the TPU's DMA
alignment; the CUDA kernel indexes the shifted X directly instead.  Its
sums run in a fixed order with no atomics (split-K partials reduced by a
second pass), so two launches on the same inputs give the same bits.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from squeezedet_torch.ops import _cuda

# Kernel launches by :func:`filter_grad` on CUDA tensors in this process.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_TILE_C = _TILE_O = 64  # the kernel's output tile
_STEP = 32              # positions the kernel stages per step
# Split the contraction until there are about this many blocks (8 for
# each of the H100's 132 SMs; at 48 registers a thread, 5 blocks of 256
# threads are resident on an SM at once), but keep at least _MIN_CHUNK
# positions in a split.
_TARGET_BLOCKS = 1056
_MIN_CHUNK = 256


def _check(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int) -> None:
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError("x must be [B, H, W, C] and dy [B, H, W, O], got "
                         "{} and {}".format(tuple(x.shape), tuple(dy.shape)))
    if x.numel() == 0 or dy.numel() == 0:
        raise ValueError("x and dy must not be empty")
    if kh < 1 or kw < 1 or kh % 2 != 1 or kw % 2 != 1:
        raise ValueError("kh and kw must be odd, got {}x{}".format(kh, kw))
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError("x and dy must both be float32 or both bfloat16, "
                        "got {} and {}".format(x.dtype, dy.dtype))
    if dy.device != x.device:
        raise ValueError("x and dy must share a device")


def filter_grad_reference(x: torch.Tensor, dy: torch.Tensor, kh: int,
                          kw: int) -> torch.Tensor:
    """Plain PyTorch K2: kh*kw f32 matmuls of the shifted, zero-padded X
    against dY -> [kh, kw, C, O] f32."""
    _check(x, dy, kh, kw)
    _, h, w, c = x.shape
    o = dy.shape[-1]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x.float(), (0, 0, pw, pw, ph, ph))
    d = dy.float().reshape(-1, o)
    out = torch.empty((kh, kw, c, o), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            out[i, j] = xp[:, i:i + h, j:j + w, :].reshape(-1, c).T @ d
    return out


def split_k(positions: int, tiles: int):
    """(splits, chunk): how the kernel cuts ``positions`` contraction
    terms for ``tiles`` output tiles; chunk is a multiple of 32 and
    splits * chunk covers every position."""
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles),
                        -(-positions // _MIN_CHUNK), 65535))
    chunk = -(-positions // splits)
    chunk = -(-chunk // _STEP) * _STEP
    return -(-positions // chunk), chunk


def filter_grad(x: torch.Tensor, dy: torch.Tensor, kh: int,
                kw: int) -> torch.Tensor:
    """K2: x [B, H, W, C], dy [B, H, W, O] (contiguous NHWC, both f32 or
    both bf16), odd kh and kw -> dW [kh, kw, C, O] f32 of the stride-1
    SAME conv of x."""
    global LAUNCHES
    _check(x, dy, kh, kw)
    if x.device.type == "cpu":
        return filter_grad_reference(x, dy, kh, kw)
    if x.device.type != "cuda":
        raise ValueError("filter_grad runs on cpu or cuda tensors, got "
                         "{}".format(x.device))
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous NHWC")
    b, h, w, c = x.shape
    o = dy.shape[-1]
    tiles = -(-c // _TILE_C) * -(-o // _TILE_O) * kh * kw
    splits, chunk = split_k(b * h * w, tiles)
    ws = torch.empty((splits, kh, kw, c, o), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((kh, kw, c, o), dtype=torch.float32, device=x.device)
    lib = _cuda.load("filter_grad")
    fn = lib.sdt_filter_grad
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 b, h, w, c, o, kh, kw, splits, chunk, _DTYPES[x.dtype],
                 stream)
    _cuda.check(lib, err, "filter_grad kernel launch")
    LAUNCHES += 1
    return out
