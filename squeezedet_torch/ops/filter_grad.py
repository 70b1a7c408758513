"""Filter gradient of a stride-1 SAME convolution (K2).

Counterpart of the Pallas kernel ``squeezedet_tpu/ops/filter_grad.py:
filter_grad``:

    dW[i, j, c, o] = sum_{b,y,x} X[b, y+i-ph, x+j-pw, c] * dY[b, y, x, o]

with X [B, H, W, C], dY [B, H, W, O] NHWC, odd kh and kw, X zero outside
the image, and dW [kh, kw, C, O] in f32.  On a CUDA tensor
:func:`filter_grad` launches the hand-written kernel in
``csrc/filter_grad.cu``; on a CPU tensor it runs
:func:`filter_grad_reference`, the plain PyTorch version.  The operands'
dtype picks the kernel's route: bf16 runs on the tensor cores (TMA loads
and ``wgmma``, or ``mma.sync`` for the small 1x1 calls :func:`uses_mma`
names; it needs C % 8 == 0, O % 8 == 0 and 16-byte aligned operands),
f32 on the CUDA cores.  Nothing falls back: a CUDA tensor the kernel does
not take raises.

The Pallas kernel's padded, guarded flat frames exist for the TPU's DMA
alignment; on the card TMA's zero fill of boxes that reach outside the
tensor makes the SAME pad.  Every sum runs in a fixed order with no float
atomics (``wgmma``: the split-K partials are summed inside the launch, in
split order; the others: by a second pass), so two launches on the same
inputs give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from squeezedet_torch.ops import _cuda

# Kernel launches by :func:`filter_grad` on CUDA tensors in this process.
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int),
                                      ctypes.c_int, ctypes.c_void_p])
_STEP = 32  # f32: every split's chunk of positions is a multiple of this

# The H100 the plan is cut for: its SMs, and the shared memory a block may
# use (227 KB), less the ring's alignment slack and the barriers
SMS = 132
RING_BYTES = 232448 - 2048


class Route(NamedTuple):
    """One dtype's kernel: its output tile, ``tile_c`` C rows by one of the
    ``widths`` of O it is built for."""
    tile_c: int
    widths: tuple


ROUTES = {
    # CUDA cores: 64 x 64 tiles
    torch.float32: Route(64, (64,)),
    # TMA + wgmma: 128 C rows (a 64-channel box for each of the two
    # consumer warpgroups) by the wgmma widths the kernel is built for
    torch.bfloat16: Route(128, (64, 72, 128, 192, 256)),
}
# f32: the contraction is split into chunks of whole steps of 32 positions
# (at least MIN_CHUNK) until there are 8 blocks for each SM (5 blocks of 256
# threads are resident on an SM at 48 registers)
F32_TARGET_BLOCKS, MIN_CHUNK = 8 * SMS, 256
# The mma.sync kernel (C x O tiles of 128 x 128, 2 blocks resident on an SM,
# so at most one wave of MMA_WAVE blocks, then a reduce pass) runs the bf16
# 1x1 calls with at most MMA_MAX_O columns of O and one C tile, or two C
# tiles where its O tiles times the positions are at most
# MMA_MAX_POSITIONS: a short call there pays less for its second pass than
# for the wgmma kernel's in-launch tree, and its cost grows with the O
# tiles it reads X again for (scripts/k2_rule.py on an H100, PERF.md
# section 6)
MMA_TILE, MMA_MAX_O, MMA_WAVE = 128, 256, 2 * SMS
MMA_MAX_POSITIONS = 90000
BOX_BYTES = 128     # a position's row in a staged box: 64 bf16 channels
MIN_WALK = 8        # boxes a split walks at least
MIN_STAGES, MAX_STAGES = 3, 8  # ring depth: the box is cut for at least
                               # the first; the kernel takes at most the
                               # second
COUNTERS = 16       # arrival counters a tile: at most 15 groups of splits
# weight of the split-K workspace's bytes (written once, read back once)
# against a stage's loads, in split_k's estimate: they go to the card's
# memory, where a stage's loads are mostly L2 hits
WS_WEIGHT = 8


class Plan(NamedTuple):
    """How ``kernel`` cuts one call: ``tiles`` output tiles (C tiles of
    ``tile_c`` x O tiles of ``tile_o`` x taps), each tile's contraction
    cut into ``splits`` chunks of ``chunk`` work units, one block each.
    Kernel 0 (f32, CUDA cores) and 2 (bf16, mma.sync): a unit is a
    position (chunk a multiple of 32), the partials summed by a second
    pass.  Kernel 1 (bf16, TMA + wgmma): a unit is a box of ``hbox`` rows
    x ``wbox`` columns of one image (boxes numbered image-major, then
    row-major), the ring holds ``stages`` boxes, and the splits' partials
    are summed in the launch in groups of ``group`` splits, then the
    groups' sums, each in order."""
    kernel: int
    tile_c: int
    tile_o: int
    tiles: int
    splits: int
    chunk: int
    hbox: int = 0
    wbox: int = 0
    group: int = 1
    stages: int = 0


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


def tile_width(o: int) -> int:
    """The bf16 kernel's O tile: the narrowest width it is built for that
    takes an equal share of O among the fewest tiles."""
    widths = ROUTES[torch.bfloat16].widths
    share = -(-o // -(-o // widths[-1]))
    return min(n for n in widths if n >= share)


def box_shape(h: int, w: int, tile_o: int) -> tuple:
    """(hbox, wbox, stages): a stage's box of positions, wbox a multiple of
    16 (wgmma's depth), at most 1 / MIN_STAGES of the ring: of the boxes
    that overhang the image least, the largest; and the ring's depth."""
    row = (2 + -(-tile_o // 64)) * BOX_BYTES  # X's two boxes and dY's
    p_max = RING_BYTES // MIN_STAGES // row // 16 * 16
    widths = {(-(-w // nx) + 15) // 16 * 16 for nx in range(1, w + 1)}
    hbox, wbox = min(((hb, wb) for wb in widths if wb <= p_max
                      for hb in range(1, min(h, p_max // wb) + 1)),
                     key=lambda box: (-(-h // box[0]) * box[0]
                                      * -(-w // box[1]) * box[1],
                                      -box[0] * box[1]))
    return hbox, wbox, min(MAX_STAGES, RING_BYTES // (hbox * wbox * row))


def split_k(boxes: int, tiles: int, stage_bytes: int,
            partial_bytes: int) -> tuple:
    """(splits, chunk, group) of each of ``tiles`` tiles' ``boxes`` boxes:
    the cut, of at least MIN_WALK boxes a split, whose estimated time is
    least, in units of a stage's loads: waves of blocks (one block an SM)
    times the boxes a split walks, plus the partials the tile's last blocks
    read (group + groups of them) and the workspace's traffic spread over
    the card.  Groups of ceil(sqrt(splits)) splits."""
    best = None
    for s in range(1, max(1, boxes // MIN_WALK) + 1):
        chunk = -(-boxes // s)
        if -(-boxes // chunk) != s:
            continue  # the same cut as a smaller s
        group = math.isqrt(s - 1) + 1
        cost = -(-tiles * s // SMS) * chunk
        if s > 1:
            cost += (group + -(-s // group)
                     + WS_WEIGHT * 2 * s * tiles / SMS) * (partial_bytes
                                                           / stage_bytes)
        if best is None or cost < best[0]:
            best = (cost, s, chunk, group)
    return best[1:]


def _position_splits(positions: int, tiles: int, blocks: int,
                     one_wave: bool) -> tuple:
    """(splits, chunk) of ``positions`` for ``tiles`` tiles: about
    ``blocks`` blocks (at most that many when ``one_wave``: one block more
    than a wave doubles the time), at least MIN_CHUNK positions a split,
    chunks a multiple of 32."""
    per_tile = blocks // tiles if one_wave else -(-blocks // tiles)
    splits = max(1, min(per_tile, -(-positions // MIN_CHUNK), 65535))
    chunk = -(-positions // splits)
    chunk = -(-chunk // _STEP) * _STEP
    return -(-positions // chunk), chunk


def uses_mma(b: int, h: int, w: int, c: int, o: int, kh: int,
             kw: int) -> bool:
    """Whether a bf16 call runs the mma.sync kernel (the fixed rule by
    shape above) rather than TMA + wgmma."""
    return (kh == kw == 1 and o <= MMA_MAX_O
            and (c <= MMA_TILE or c <= 2 * MMA_TILE and -(-o // MMA_TILE)
                 * b * h * w <= MMA_MAX_POSITIONS))


def mma_plan(b: int, h: int, w: int, c: int, o: int, kh: int,
             kw: int) -> Plan:
    """The mma.sync kernel's plan of a bf16 call: 128 x 128 tiles, chunks
    of positions up to one wave of blocks."""
    tiles = -(-c // MMA_TILE) * -(-o // MMA_TILE) * kh * kw
    return Plan(2, MMA_TILE, MMA_TILE, tiles,
                *_position_splits(b * h * w, tiles, MMA_WAVE, True))


def wgmma_plan(b: int, h: int, w: int, c: int, o: int, kh: int,
               kw: int) -> Plan:
    """The TMA + wgmma kernel's plan of a bf16 call."""
    route = ROUTES[torch.bfloat16]
    n = tile_width(o)
    tiles = -(-c // route.tile_c) * -(-o // n) * kh * kw
    hbox, wbox, stages = box_shape(h, w, n)
    boxes = b * -(-h // hbox) * -(-w // wbox)
    splits, chunk, group = split_k(
        boxes, tiles, (2 + -(-n // 64)) * hbox * wbox * BOX_BYTES,
        min(c, route.tile_c) * min(o, n) * 4)
    return Plan(1, route.tile_c, n, tiles, splits, chunk, hbox, wbox, group,
                stages)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, o: int, kh: int, kw: int,
         dtype: torch.dtype) -> Plan:
    """The launch plan of one K2 call on ``dtype`` operands (a function of
    the shape alone, cached: searching it costs tens of microseconds)."""
    if dtype == torch.float32:
        route = ROUTES[dtype]
        tiles = -(-c // route.tile_c) * -(-o // route.widths[0]) * kh * kw
        return Plan(0, route.tile_c, route.widths[0], tiles,
                    *_position_splits(b * h * w, tiles, F32_TARGET_BLOCKS,
                                      False))
    if uses_mma(b, h, w, c, o, kh, kw):
        return mma_plan(b, h, w, c, o, kh, kw)
    return wgmma_plan(b, h, w, c, o, kh, kw)


def workspace_words(p: Plan, kh: int, kw: int, c: int, o: int) -> int:
    """4-byte words of the call's workspace, none for one split.  Kernels
    0 and 2: the splits' partials.  Kernel 1 (as csrc/filter_grad.cu lays
    it out): COUNTERS arrival counters a tile, then a partial slot of
    tile_c x tile_o floats for each (split, tile)."""
    if p.splits == 1:
        return 0
    if p.kernel != 1:
        return p.splits * kh * kw * c * o
    return p.tiles * (COUNTERS + p.splits * p.tile_c * p.tile_o)


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
    _check(x, dy, kh, kw)
    if x.device.type == "cpu":
        return filter_grad_reference(x, dy, kh, kw)
    if x.device.type != "cuda":
        raise ValueError("filter_grad runs on cpu or cuda tensors, got "
                         "{}".format(x.device))
    check_kernel_layout(x, dy)
    b, h, w, c = x.shape
    return launch(x, dy, kh, kw, plan(b, h, w, c, dy.shape[-1], kh, kw,
                                      x.dtype))


def launch(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
           p: Plan) -> torch.Tensor:
    """One launch of the kernel ``p`` names on checked CUDA operands ->
    dW [kh, kw, C, O] f32."""
    global LAUNCHES
    b, h, w, c = x.shape
    o = dy.shape[-1]
    ws = torch.empty(workspace_words(p, kh, kw, c, o), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((kh, kw, c, o), dtype=torch.float32, device=x.device)
    geo = (ctypes.c_int * 14)(b, h, w, c, o, kh, kw, p.splits, p.chunk,
                              p.tile_o, p.hbox, p.wbox, p.group, p.stages)
    fn = _cuda.function("filter_grad", "sdt_filter_grad", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                 geo, p.kernel, stream)
    _cuda.check("filter_grad", err, "filter_grad kernel launch")
    LAUNCHES += 1
    return out
