"""Filter gradient of a stride-1 SAME convolution (K2).

Counterpart of the Pallas kernel ``squeezedet_tpu/ops/filter_grad.py:
filter_grad``:

    dW[i, j, c, o] = sum_{b,y,x} X[b, y+i-ph, x+j-pw, c] * dY[b, y, x, o]

with X [B, H, W, C], dY [B, H, W, O] NHWC, odd kh and kw, X zero outside
the image, and dW [kh, kw, C, O] in f32.  On a CUDA tensor
:func:`filter_grad` launches the hand-written kernel in
``csrc/filter_grad.cu``; on a CPU tensor it runs
:func:`filter_grad_reference`, the plain PyTorch version.  The operands'
dtype picks the kernel's route: bf16 runs on the tensor cores (and needs
C % 8 == 0, O % 8 == 0 and 16-byte aligned operands), f32 on the CUDA
cores.  Nothing falls back: a CUDA tensor the kernel does not take raises.

The Pallas kernel's padded, guarded flat frames exist for the TPU's DMA
alignment; the CUDA kernel indexes the shifted X directly instead.  Its
sums run in a fixed order with no atomics (split-K partials reduced by a
second pass), so two launches on the same inputs give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from squeezedet_torch.ops import _cuda

# Kernel launches by :func:`filter_grad` on CUDA tensors in this process.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_STEP = 32  # every split's chunk of positions is a multiple of this


class Route(NamedTuple):
    """One dtype's kernel: its output tile and how far the contraction is
    split.  The contraction is split until there are about
    ``target_blocks`` blocks (at most that many when ``one_wave``),
    keeping at least ``min_chunk`` positions in a split."""
    tile_c: int
    tile_o: int
    target_blocks: int
    min_chunk: int
    one_wave: bool


ROUTES = {
    # CUDA cores: 64 x 64 tiles; 8 blocks for each of the H100's 132 SMs
    # (5 blocks of 256 threads are resident on an SM at 48 registers)
    torch.float32: Route(64, 64, 1056, 256, False),
    # tensor cores: C tiles of 128, O tiles of up to 128 (all of O in
    # squeezeDet), 96 KB of shared memory and <= 128 registers a thread:
    # 2 blocks are resident on an SM, so at most one wave of 264 blocks,
    # since every further split adds a C x O f32 partial written and read
    # back (at B=20 the workspace already moves 0.2-1x the operands' bytes)
    torch.bfloat16: Route(128, 128, 264, 256, True),
}


class Plan(NamedTuple):
    """How the kernel cuts one call: ``tiles`` output tiles (C tiles x O
    tiles x taps), each contraction over the positions cut into ``splits``
    chunks of ``chunk`` positions (a multiple of 32)."""
    tiles: int
    splits: int
    chunk: int


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


def split_k(positions: int, tiles: int, route: Route = ROUTES[torch.float32]):
    """(splits, chunk): how the kernel cuts ``positions`` contraction
    terms for ``tiles`` output tiles; chunk is a multiple of 32 and
    splits * chunk covers every position."""
    # the f32 route rounds its block count up to the target; the bf16
    # route, whose target is exactly one wave, rounds down, since one
    # block more than a wave doubles the time
    per_tile = (route.target_blocks // tiles if route.one_wave
                else -(-route.target_blocks // tiles))
    splits = max(1, min(per_tile, -(-positions // route.min_chunk), 65535))
    chunk = -(-positions // splits)
    chunk = -(-chunk // _STEP) * _STEP
    return -(-positions // chunk), chunk


def plan(b: int, h: int, w: int, c: int, o: int, kh: int, kw: int,
         dtype: torch.dtype) -> Plan:
    """The launch plan of one K2 call on ``dtype`` operands."""
    route = ROUTES[dtype]
    tiles = -(-c // route.tile_c) * -(-o // route.tile_o) * kh * kw
    return Plan(tiles, *split_k(b * h * w, tiles, route))


def check_kernel_layout(x: torch.Tensor, dy: torch.Tensor) -> None:
    """What the CUDA kernel needs beyond :func:`_check`: contiguous NHWC
    operands and, for the bf16 (tensor-core) route, whole 16-byte chunks
    of channels in every row at 16-byte aligned addresses."""
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous NHWC")
    if x.dtype != torch.bfloat16:
        return
    c, o = x.shape[-1], dy.shape[-1]
    if c % 8 or o % 8:
        raise ValueError("bf16 filter_grad needs C % 8 == 0 and O % 8 == 0, "
                         "got C={} O={}".format(c, o))
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("bf16 filter_grad needs 16-byte aligned x and dy")


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
    check_kernel_layout(x, dy)
    b, h, w, c = x.shape
    o = dy.shape[-1]
    p = plan(b, h, w, c, o, kh, kw, x.dtype)
    # one split writes dW directly; more write partials to the workspace
    ws = torch.empty((p.splits if p.splits > 1 else 0, kh, kw, c, o),
                     dtype=torch.float32, device=x.device)
    out = torch.empty((kh, kw, c, o), dtype=torch.float32, device=x.device)
    fn = _cuda.function("filter_grad", "sdt_filter_grad", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 b, h, w, c, o, kh, kw, p.splits, p.chunk, _DTYPES[x.dtype],
                 stream)
    _cuda.check("filter_grad", err, "filter_grad kernel launch")
    LAUNCHES += 1
    return out
