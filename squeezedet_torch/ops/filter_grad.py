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
f32 on the CUDA cores (TMA loads into a ring and 8 x 8-style register
tiles where :func:`uses_f32_tma` says a tensor map describes the
operands, else a CUDA-core kernel of scalar loads, which takes any C
and O).
Nothing falls back to the plain version: a CUDA tensor the kernels do
not take raises.

The Pallas kernel's padded, guarded flat frames exist for the TPU's DMA
alignment; on the card TMA's zero fill of boxes that reach outside the
tensor makes the SAME pad.  Every sum runs in a fixed order with no float
atomics (``wgmma``: the split-K partials are summed inside the launch, in
split order; the others: by a second pass, in split order), so two
launches on the same inputs give the same bits.
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

# The H100 the plan is cut for: its SMs, the shared memory a block may
# use (227 KB), less the ring's alignment slack and the barriers, and its
# memory's rate (data sheet)
SMS = 132
RING_BYTES = 232448 - 2048
HBM_BYTES_PER_S = 3.35e12


class Route(NamedTuple):
    """One dtype's kernel: its output tile, ``tile_c`` C rows by one of the
    ``widths`` of O it is built for."""
    tile_c: int
    widths: tuple


ROUTES = {
    # CUDA cores, TMA ring: 128 C rows (one X box) by an O tile that fits O
    # (or an equal share of O, at most 128 wide)
    torch.float32: Route(128, (32, 48, 64, 72, 96, 128)),
    # TMA + wgmma: 128 C rows (a 64-channel box for each of the two
    # consumer warpgroups) by the wgmma widths the kernel is built for
    torch.bfloat16: Route(128, (64, 72, 128, 192, 256)),
}
# The scalar-load f32 kernel (CUDA cores, 64 x 64 tiles), kept for
# the f32 calls a tensor map cannot describe (C % 4 or O % 4 not 0, or
# operands not 16-byte aligned): its contraction is split into chunks of
# whole steps of 32 positions (at least MIN_CHUNK) until there are 8
# blocks for each SM
F32_SCALAR_TILE, F32_TARGET_BLOCKS, MIN_CHUNK = 64, 8 * SMS, 256
# The f32 TMA kernel: 2 blocks of 256 threads resident on an SM, so a
# block's ring may take half the SM's 228 KB of shared memory, less the
# block's reserved 1 KB, its barriers and the ring's alignment; the box is
# cut for F32_MIN_STAGES stages, and a stage costs about F32_STAGE_COST
# positions' work besides its positions (its barrier wait, sync and
# refill).  In split_f32's estimate of a cut's time: F32_FMA_PER_S, an
# SM's f32 FMAs a second (128 lanes at ~1.75 GHz); F32_LONE, the share of
# that rate one block alone on an SM keeps (8 warps); F32_SPLIT_S, the
# reduce pass's fixed cost
F32_RING = 232448 // 2 - 1024 - 256
F32_MIN_STAGES, F32_STAGE_COST = 3, 8
F32_FMA_PER_S, F32_LONE, F32_SPLIT_S = 128 * 1.75e9, 0.75, 3e-6
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
    Kernel 0 (f32, CUDA cores, scalar loads) and 2 (bf16, mma.sync): a
    unit is a position (chunk a multiple of 32), the partials summed by a
    second pass.  Kernels 1 (bf16, TMA + wgmma) and 3 (f32, TMA + CUDA
    cores): a unit is a box of ``hbox`` rows x ``wbox`` columns of one
    image (boxes numbered image-major, then row-major) and the ring holds
    ``stages`` boxes; kernel 1 sums the splits' partials in the launch in
    groups of ``group`` splits, then the groups' sums, each in order;
    kernel 3 by a second pass, in split order."""
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
    if dy.device != x.device:
        raise ValueError("x and dy must share a device")


def filter_grad_reference(x: torch.Tensor, dy: torch.Tensor, kh: int,
                          kw: int) -> torch.Tensor:
    """Plain PyTorch K2: kh*kw f32 matmuls of the shifted, zero-padded X
    against dY -> [kh, kw, C, O] f32 (f64 matmuls and result for f64
    operands, which hold the kernel's error)."""
    _check(x, dy, kh, kw)
    dtype = torch.promote_types(x.dtype, torch.float32)
    _, h, w, c = x.shape
    o = dy.shape[-1]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x.to(dtype), (0, 0, pw, pw, ph, ph))
    d = dy.to(dtype).reshape(-1, o)
    out = torch.empty((kh, kw, c, o), dtype=dtype, device=x.device)
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


def uses_f32_tma(c: int, o: int) -> bool:
    """Whether an f32 call runs the TMA kernel (the fixed rule by shape):
    a tensor map needs 16-byte row strides, so C % 4 == 0 and O % 4 == 0
    (every model shape; the wrapper also needs 16-byte aligned operands).
    Other f32 calls run the scalar-load kernel."""
    return c % 4 == 0 and o % 4 == 0


def f32_width(o: int) -> int:
    """The f32 TMA kernel's O tile: the narrowest width it is built for
    that takes an equal share of O among the fewest tiles of at most 128."""
    widths = ROUTES[torch.float32].widths
    share = -(-o // -(-o // widths[-1]))
    return min(n for n in widths if n >= share)


def f32_stage_bytes(positions: int, tile_o: int) -> int:
    """Shared bytes of one stage of the f32 TMA ring: the X box (128
    channels) and the dY box (tile_o columns) of ``positions`` positions,
    rounded up to 128 bytes (each box lands 128-byte aligned)."""
    return -(-positions * (ROUTES[torch.float32].tile_c + tile_o) * 4
             // 128) * 128


def split_f32(boxes: int, tiles: int, positions: int, tile_o: int,
              taps_c_o: int, limit: int) -> tuple:
    """(splits, chunk) of each of ``tiles`` tiles' ``boxes`` boxes for the
    f32 TMA kernel: of the cuts into at most ``limit`` splits (so that the
    workspace is never larger than the scalar-load kernel's), the one whose
    estimated time is least: the blocks an SM runs (2 at a time share it;
    one alone keeps F32_LONE of its rate) times the FMAs of a split, plus,
    with more than one split, the reduce pass: its fixed cost and the
    partials' (``taps_c_o`` floats a split) bytes written and read
    back."""
    best = None
    fmas = (positions + F32_STAGE_COST) * ROUTES[torch.float32].tile_c \
        * tile_o
    for s in range(1, max(1, min(boxes, limit)) + 1):
        chunk = -(-boxes // s)
        if -(-boxes // chunk) != s:
            continue  # the same cut as a smaller s
        per_sm = -(-tiles * s // SMS)
        cost = (per_sm if per_sm > 1 else 1 / F32_LONE) * chunk * fmas \
            / F32_FMA_PER_S
        if s > 1:
            cost += F32_SPLIT_S + 2 * 4 * s * taps_c_o / HBM_BYTES_PER_S
        if best is None or cost < best[0]:
            best = (cost, s, chunk)
    return best[1:]


def f32_box(h: int, w: int, p_max: int) -> tuple:
    """(hbox, wbox) of the f32 TMA kernel: of the boxes of at most
    ``p_max`` positions, each side at most 256 (TMA's limit), one of those
    whose boxes over the h x w image cost least, a box counted as its
    positions plus F32_STAGE_COST; of those, the largest, then the
    widest."""
    widths = {-(-w // nx) for nx in range(1, w + 1)}
    return min(((hb, wb) for wb in widths if wb <= min(p_max, 256)
                for hb in range(1, min(h, p_max // wb, 256) + 1)),
               key=lambda box: (-(-h // box[0]) * -(-w // box[1])
                                * (box[0] * box[1] + F32_STAGE_COST),
                                -box[0] * box[1], -box[1]))


def f32_plan(b: int, h: int, w: int, c: int, o: int, kh: int,
             kw: int) -> Plan:
    """The f32 TMA kernel's plan: 128 x tile_o tiles, a box cut for
    F32_MIN_STAGES stages, and the split cut :func:`split_f32` picks."""
    n = f32_width(o)
    tiles = -(-c // 128) * -(-o // n) * kh * kw
    row = (128 + n) * 4
    # a stage rounds up to 128 bytes: the box leaves room for that
    hbox, wbox = f32_box(h, w, (F32_RING // F32_MIN_STAGES - 127) // row)
    stages = min(MAX_STAGES, F32_RING // f32_stage_bytes(hbox * wbox, n))
    boxes = b * -(-h // hbox) * -(-w // wbox)
    limit = cuda_core_plan(b, h, w, c, o, kh, kw).splits
    splits, chunk = split_f32(boxes, tiles, hbox * wbox, n, kh * kw * c * o,
                              limit)
    return Plan(3, 128, n, tiles, splits, chunk, hbox, wbox, 1, stages)


def cuda_core_plan(b: int, h: int, w: int, c: int, o: int, kh: int,
                   kw: int) -> Plan:
    """The scalar-load f32 kernel's plan: 64 x 64 tiles, chunks of positions
    until there are F32_TARGET_BLOCKS blocks."""
    tiles = -(-c // F32_SCALAR_TILE) * -(-o // F32_SCALAR_TILE) * kh * kw
    return Plan(0, F32_SCALAR_TILE, F32_SCALAR_TILE, tiles,
                *_position_splits(b * h * w, tiles, F32_TARGET_BLOCKS,
                                  False))


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
        if uses_f32_tma(c, o):
            return f32_plan(b, h, w, c, o, kh, kw)
        return cuda_core_plan(b, h, w, c, o, kh, kw)
    if uses_mma(b, h, w, c, o, kh, kw):
        return mma_plan(b, h, w, c, o, kh, kw)
    return wgmma_plan(b, h, w, c, o, kh, kw)


def workspace_words(p: Plan, kh: int, kw: int, c: int, o: int) -> int:
    """4-byte words of the call's workspace, none for one split.  Kernels
    0, 2 and 3: the splits' partials.  Kernel 1 (as csrc/filter_grad.cu lays
    it out): COUNTERS arrival counters a tile, then a partial slot of
    tile_c x tile_o floats for each (split, tile)."""
    if p.splits == 1:
        return 0
    if p.kernel != 1:
        return p.splits * kh * kw * c * o
    return p.tiles * (COUNTERS + p.splits * p.tile_c * p.tile_o)


def padding_share(p: Plan, b: int, h: int, w: int, c: int, o: int) -> float:
    """The share of the multiply-adds plan ``p`` runs that fall on padding:
    ragged C and O tiles (kernel 2 skips the n8 tiles past O), boxes past
    the image's edge (kernels 1 and 3) or the last split's positions past
    the end (kernels 0 and 2)."""
    rows, cols = -(-c // p.tile_c) * p.tile_c, -(-o // p.tile_o) * p.tile_o
    if p.kernel == 2:
        cols = o
    if p.kernel in (1, 3):
        units = b * -(-h // p.hbox) * -(-w // p.wbox) * p.hbox * p.wbox
    else:
        units = p.splits * p.chunk
    return 1 - b * h * w * c * o / (units * rows * cols)


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
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError("x and dy must both be float32 or both bfloat16, "
                        "got {} and {}".format(x.dtype, dy.dtype))
    if x.device.type == "cpu":
        return filter_grad_reference(x, dy, kh, kw)
    if x.device.type != "cuda":
        raise ValueError("filter_grad runs on cpu or cuda tensors, got "
                         "{}".format(x.device))
    check_kernel_layout(x, dy)
    b, h, w, c = x.shape
    o = dy.shape[-1]
    p = plan(b, h, w, c, o, kh, kw, x.dtype)
    if p.kernel == 3 and (x.data_ptr() % 16 or dy.data_ptr() % 16):
        p = cuda_core_plan(b, h, w, c, o, kh, kw)  # no tensor map
    return launch(x, dy, kh, kw, p)


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
