"""conv1 + bias + ReLU + pool1 in one kernel (K1).

Counterpart of the Pallas kernel ``squeezedet_tpu/ops/fused_frontend.py:
conv1_pool1_fused``: ``max_pool_3x3_s2_SAME(relu(conv_3x3_s2_SAME(x, k)
+ b))``, the squeezeDet conv1+pool1 stack.  On a CUDA tensor
:func:`conv1_pool1` launches the hand-written kernel in
``csrc/conv1_pool1.cu``; on a CPU tensor it runs
:func:`conv1_pool1_reference`, the plain PyTorch version of the same
function.  The images' dtype picks the kernel's route: bf16 runs the
conv on the tensor cores (and needs 16-byte aligned images), f32 on the
CUDA cores in f32 FMAs (any 4-byte aligned start; its launch plan is
:func:`f32_plan`).  Nothing falls back: a CUDA tensor the kernel does
not take raises, and so does a CUDA call that autograd would
differentiate (the kernel has no backward; the plain version on the CPU
does).

Numerics of both versions: the kernel and bias are rounded to the
images' dtype (as the JAX layer casts them), everything after that is
f32 (sum, bias, ReLU, max), and the result is rounded to the images'
dtype once.  Padding is TF SAME for the conv and the pool, so any H and
W are taken.

On a tile of a spatially partitioned frame the kernel is launched with
the tile's true geometry (``geo``, from :func:`tile_geometry`): the
kernel takes the whole geometry as arguments (input, conv and pool
extents and the leading pads), zero-pads input rows outside the window
it is given and skips conv rows outside the conv extent it is given.
So a tile's window is the input rows its pool rows read, clamped to the
frame: an interior tile gets no pads (its neighbours' rows are real
rows of the window), the frame's first tile the frame's leading pads,
and its last tile runs off the window's end where the frame ends.  The
plain version takes the same geometry.  The loop over the tiles is the
model's (``models/squeezedet.py``).

:func:`conv1_pool1` calls the op ``squeezedet_torch::conv1_pool1``,
registered here with ``torch.library.custom_op``: its CUDA
implementation launches the kernel, its CPU one is the plain version,
and its fake implementation gives the output's shape, so that
``torch.export`` traces the op into an artifact (``serving.py``) and the
artifact launches the kernel (and counts in :data:`LAUNCHES`) when it
runs.  The op has no autograd formula: on the CPU, a call that needs a
gradient runs the plain version directly.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from squeezedet_torch.models.halo import chain_window
from squeezedet_torch.models.layers import same_padding
from squeezedet_torch.ops import _cuda

# Kernel launches by :func:`conv1_pool1` on CUDA tensors in this process,
# and those of them on the f32 route.
LAUNCHES = 0
F32_LAUNCHES = 0

FILTERS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]


# The f32 route's launch plan (csrc/conv1_pool1.cu f32_plan, the same
# function): a warp walks a strip of F32_STRIP pool columns down a run of
# pool rows, F32_WARPS warps a block; SMS is the H100's SM count.
F32_STRIP = 15
F32_WARPS = 4
F32_MIN_LOAD = 2
SMS = 132


class F32Plan(NamedTuple):
    tile_rows: int  # pool rows of a warp tile (the last run may be short)
    segs: int       # runs of pool rows an image
    strips: int     # strips of F32_STRIP pool columns an image
    tiles: int      # warp tiles: images x segs x strips
    blocks: int


def f32_plan(b: int, hp: int, wp: int, sms: int = SMS) -> F32Plan:
    """The f32 kernel's launch plan for ``b`` images of ``hp`` x ``wp``
    pool outputs: of the cuts of the pool rows into runs of equal length
    (the last shorter), the one whose estimated time is least, the first
    on a tie.  The estimate is the blocks an SM takes (at least
    F32_MIN_LOAD: one block alone on an SM waits on latency more than on
    issue) times the conv rows a warp computes for its run (2 rows + 1:
    the row two runs share is computed by both).  All zeros when there is
    no pool output (the kernel then refuses the call)."""
    strips = -(-wp // F32_STRIP)
    best = None
    for segs in range(1, hp + 1):
        rows = -(-hp // segs)
        if -(-hp // rows) != segs:
            continue  # the same cut as fewer runs
        tiles = b * segs * strips
        blocks = -(-tiles // F32_WARPS)
        if blocks > 2 ** 31 - 1:
            continue  # past the grid's x limit
        cost = max(-(-blocks // sms), F32_MIN_LOAD) * (2 * rows + 1)
        if best is None or cost < best[0]:
            best = (cost, F32Plan(rows, segs, strips, tiles, blocks))
    return F32Plan(0, 0, 0, 0, 0) if best is None else best[1]


def geometry(height: int, width: int):
    """(Hc, Wc, Hp, Wp, pad_t, pad_l, ppad_t, ppad_l): conv and pool output
    sizes and their TF SAME leading pads for a 3x3 s2 conv then pool."""
    hc, pad_t, _ = same_padding(height, 3, 2)
    wc, pad_l, _ = same_padding(width, 3, 2)
    hp, ppad_t, _ = same_padding(hc, 3, 2)
    wp, ppad_l, _ = same_padding(wc, 3, 2)
    return hc, wc, hp, wp, pad_t, pad_l, ppad_t, ppad_l


def tile_geometry(height: int, width: int, rows, cols):
    """The input window ``((r0, r1), (c0, c1))`` of the tile owning pool
    rows ``rows`` and columns ``cols`` (pairs) of a ``height x width``
    frame (``halo.chain_window`` through the conv and the pool), and its
    kernel geometry in :func:`geometry`'s order."""
    ops = ((3, 2, "SAME"), (3, 2, "SAME"))
    win_r, ((hc, pt), (hp, ppt)) = chain_window(rows, height, ops)
    win_c, ((wc, pl), (wp, ppl)) = chain_window(cols, width, ops)
    return (win_r, win_c), (hc, wc, hp, wp, pt, pl, ppt, ppl)


def _check(images, kernel, bias) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError("images must be [B, H, W, 3], got {}".format(
            tuple(images.shape)))
    if images.dtype not in _DTYPES:
        raise TypeError("images must be float32 or bfloat16, got {}".format(
            images.dtype))
    if tuple(kernel.shape) != (3, 3, 3, FILTERS) or \
            tuple(bias.shape) != (FILTERS,):
        raise ValueError("kernel must be [3, 3, 3, {0}] HWIO and bias [{0}], "
                         "got {1} and {2}".format(FILTERS, tuple(kernel.shape),
                                                  tuple(bias.shape)))
    if kernel.device != images.device or bias.device != images.device:
        raise ValueError("images, kernel and bias must share a device")


def check_kernel_layout(images) -> None:
    """What the CUDA kernel needs of the images beyond :func:`_check`:
    contiguous NHWC, and for the bf16 (tensor-core) route a 16-byte
    aligned start, which its 16-byte loads assume (the f32 route copies
    4 bytes at a time, so it takes any start a float may have)."""
    if not images.is_contiguous():
        raise ValueError("images must be contiguous NHWC")
    if images.dtype == torch.bfloat16 and images.data_ptr() % 16:
        raise ValueError("bf16 conv1_pool1 needs 16-byte aligned images")


def check_no_grad(images, kernel, bias) -> None:
    """Refuse a call whose result autograd would differentiate.

    The CUDA kernel has no backward: its output carries no graph, so a
    gradient into the images, kernel or bias would silently vanish.
    squeezeDet's conv1 is frozen and its input needs no gradient, so the
    train step never asks for one; anything that does must fail loudly.
    """
    if not torch.is_grad_enabled():
        return
    wants = [name for name, t in (("images", images), ("kernel", kernel),
                                  ("bias", bias)) if t.requires_grad]
    if wants:
        raise RuntimeError(
            "conv1_pool1's CUDA kernel has no backward, but {} require(s) "
            "grad; freeze conv1 or call it under torch.no_grad()".format(
                ", ".join(wants)))


def conv1_pool1_reference(images: torch.Tensor, kernel: torch.Tensor,
                          bias: torch.Tensor,
                          geo: Optional[List[int]] = None) -> torch.Tensor:
    """Plain PyTorch conv1+pool1: [B, H, W, 3] -> [B, Hp, Wp, 64] NHWC.
    ``geo`` is the kernel's geometry (:func:`geometry`'s order; the
    frame's TF SAME geometry when None): input rows outside the images
    are zeros, conv rows outside ``Hc`` x ``Wc`` are skipped."""
    _check(images, kernel, bias)
    dtype = images.dtype
    _, h, w, _ = images.shape
    hc, wc, hp, wp, pt, pl, ppt, ppl = geometry(h, w) if geo is None \
        else geo
    pb, pr = 2 * hc + 1 - pt - h, 2 * wc + 1 - pl - w
    x = F.pad(images.float().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    k = kernel.to(dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(x, k, stride=2) + bias.to(dtype).float().view(1, -1, 1, 1)
    y = F.relu(y)
    pb, pr = 2 * hp + 1 - ppt - hc, 2 * wp + 1 - ppl - wc
    y = F.max_pool2d(F.pad(y, (ppl, pr, ppt, pb), value=-math.inf), 3, 2)
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def conv1_pool1(images: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor,
                geo: Optional[List[int]] = None) -> torch.Tensor:
    """conv1+pool1: images [B, H, W, 3] (f32 or bf16, contiguous NHWC),
    kernel [3, 3, 3, 64] HWIO, bias [64] -> [B, Hp, Wp, 64] NHWC in the
    images' dtype.  ``out.permute(0, 3, 1, 2)`` is the same tensor as
    NCHW in ``channels_last`` memory format.  ``geo``: a tile's geometry
    (:func:`tile_geometry`), the frame's TF SAME one when None.  On the
    card, the kernel through the registered op; on the CPU, the plain
    version (directly when autograd needs its graph, else through the
    op)."""
    _check(images, kernel, bias)
    device = images.device.type
    if device not in ("cpu", "cuda", "meta"):
        raise ValueError("conv1_pool1 runs on cpu or cuda tensors, got "
                         "{}".format(images.device))
    if device == "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (images, kernel, bias)):
        return conv1_pool1_reference(images, kernel, bias, geo)
    check_no_grad(images, kernel, bias)
    if not 1 <= images.shape[0] <= 65535:
        raise ValueError("batch must be 1..65535, got {}".format(
            images.shape[0]))
    return torch.ops.squeezedet_torch.conv1_pool1(images, kernel, bias, geo)


@torch.library.custom_op("squeezedet_torch::conv1_pool1", mutates_args=(),
                         device_types="cpu")
def _conv1_pool1_op(images: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor,
                    geo: Optional[List[int]] = None) -> torch.Tensor:
    return conv1_pool1_reference(images, kernel, bias, geo)


@_conv1_pool1_op.register_fake
def _conv1_pool1_fake(images, kernel, bias, geo=None):
    b, h, w, _ = images.shape
    _, _, hp, wp = (geometry(h, w) if geo is None else geo)[:4]
    return images.new_empty((b, hp, wp, FILTERS))


@_conv1_pool1_op.register_kernel("cuda")
def _conv1_pool1_cuda(images, kernel, bias, geo=None):
    """Launch the kernel of csrc/conv1_pool1.cu on the current stream."""
    global LAUNCHES, F32_LAUNCHES
    check_kernel_layout(images)
    b, h, w, _ = images.shape
    geo = geometry(h, w) if geo is None else tuple(geo)
    dtype = images.dtype
    k = kernel.detach().to(dtype).float().contiguous()
    bs = bias.detach().to(dtype).float().contiguous()
    out = torch.empty((b, geo[2], geo[3], FILTERS), dtype=dtype,
                      device=images.device)
    fn = _cuda.function("conv1_pool1", "sdt_conv1_pool1", _ARGTYPES)
    launches = ctypes.c_int(0)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(images.data_ptr(), k.data_ptr(), bs.data_ptr(),
                 out.data_ptr(), b, h, w, *geo, _DTYPES[dtype], stream,
                 ctypes.byref(launches))
    LAUNCHES += launches.value
    if dtype == torch.float32:
        F32_LAUNCHES += launches.value
    _cuda.check("conv1_pool1", err, "conv1_pool1 kernel launch")
    return out
