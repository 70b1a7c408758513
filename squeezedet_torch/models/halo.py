"""Spatial partitioning by hand: activations split into a grid of height x
width tiles, with the halo exchanges every conv and pool needs.

The JAX package shards the image height (and width) over mesh axes and
lets XLA's SPMD partitioner insert the halo exchanges
(``squeezedet_tpu/parallel/spatial.py``).  The port has no partitioner,
so this module is that exchange:

* :class:`Tiling`: a grid of ``n_h x n_w`` tiles and the device of each
  (tiles may share a device); :meth:`Tiling.split` cuts an NHWC batch on
  its home device into a :class:`Tiled` activation, on the boundaries of
  the net's output grid (:func:`image_bounds`), so that every stride-2
  stage halves them;
* :class:`Tiled`: the tiles of one activation, each owning the rows
  ``rows[i]:rows[i + 1]`` and the columns ``cols[j]:cols[j + 1]`` of the
  frame (a tile may own none, when there are more tiles than grid
  cells);
* :func:`windowed`: one conv or pool over a :class:`Tiled` input.  Each
  output tile owns the rows ``ceil(r / stride)`` of its input tile
  (:func:`next_bounds`), fetches the input window its outputs read
  (:func:`op_window`) from every tile that owns a row or column of it
  (:meth:`Tiled.window`),
  pads the window only where it passes the frame's edge (zeros for a
  conv, the dtype's lowest value for a max-pool) and runs the op on it
  VALID, on the tile's device.  A fetch is ``narrow`` + ``to(device)`` +
  ``cat`` + ``pad``, all differentiable: autograd sums a halo row's
  gradient back into the tile that owns it, and a weight copied to
  another device sums its gradient back into the home parameter;
* :meth:`Tiled.gather`: the tiles concatenated on the home device, which
  is where the detection head's interpretation, loss and postprocess
  run (the JAX package gathers there too);
* :func:`chain_window`: the input window of a tile's outputs through
  several ops chained in one call (K1's conv and pool), clamped to the
  frame, with each op's extent and leading pad over that window.

The module imports nothing but torch: the layer library and K1's
wrapper build on it, and the meshes of ``parallel/`` hand it devices.

Every tile's work is enqueued on its device's current stream, all tiles
of a layer before the next layer, and nothing waits on the host: the
tiles of one card run one after another on that card, the tiles of
different cards side by side.  :data:`COPIES` and :data:`BYTES` count the
halo pieces fetched from another tile; :func:`trace` records each op's
tile bounds and each tile's output extent.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# halo pieces fetched from another tile, and their bytes, in this process
COPIES = 0
BYTES = 0
_TRACE: Optional[list] = None
# total stride of every backbone's output grid
GRID_STRIDE = 16

Bounds = Tuple[int, ...]


def image_bounds(extent: int, grid: int, n: int) -> Bounds:
    """The ``n + 1`` boundaries of ``n`` tiles along an image dimension of
    ``extent`` pixels whose net has ``grid`` output cells: cell
    ``i * grid // n`` starts tile ``i``, so each tile owns an even share
    of the output grid and every boundary is a multiple of GRID_STRIDE;
    the last tile also takes the pixels past the grid (VALID stages)."""
    if n < 1:
        raise ValueError("a tiling needs at least one tile a dimension, "
                         "got {}".format(n))
    return tuple(min(i * grid // n * GRID_STRIDE, extent)
                 for i in range(n)) + (extent,)


def next_bounds(bounds: Bounds, stride: int, extent: int) -> Bounds:
    """The output boundaries of an op of ``stride`` over ``bounds``: an
    output row belongs to the tile holding the input row at ``stride``
    times its index, clamped to the output's ``extent``."""
    return tuple(min(-(-b // stride), extent) for b in bounds[:-1]) + \
        (extent,)


def _out_geometry(size: int, k: int, s: int, padding: str):
    """(output extent, leading pad) of a TF SAME or VALID op."""
    if padding == "SAME":
        out = -(-size // s)
        return out, max((out - 1) * s + k - size, 0) // 2
    if padding == "VALID":
        return -(-(size - k + 1) // s), 0
    raise ValueError("padding must be SAME or VALID, got {!r}".format(
        padding))


def op_window(q0: int, q1: int, size: int, k: int, s: int,
              padding: str) -> Tuple[int, int]:
    """The input positions ``[lo, hi)`` that outputs ``[q0, q1)`` of a
    TF ``padding`` op of kernel ``k`` and stride ``s`` read over an input
    of ``size``; ``lo < 0`` or ``hi > size`` where they read padding."""
    _, lead = _out_geometry(size, k, s, padding)
    return q0 * s - lead, (q1 - 1) * s - lead + k


def chain_window(q: Tuple[int, int], size: int, ops):
    """For outputs ``q = (q0, q1)`` of the ``ops`` ((kernel, stride,
    padding) each, first to last) chained over an input of ``size``: the
    input window ``(i0, i1)`` they read, clamped to the input, and for
    each op, first to last, (its extent on the tile, the leading pad its
    window starts with): the positions of the frame's padding before the
    clamped window, the only padding an interior tile sees."""
    sizes = [size]
    for k, s, padding in ops:
        sizes.append(_out_geometry(sizes[-1], k, s, padding)[0])
    geo = []
    for n, (k, s, padding) in zip(reversed(sizes[:-1]), reversed(ops)):
        lo, hi = op_window(q[0], q[1], n, k, s, padding)
        clamped = (max(lo, 0), min(hi, n))
        geo.append((q[1] - q[0], clamped[0] - lo))
        q = clamped
    return q, geo[::-1]


@contextlib.contextmanager
def trace():
    """Record, for each tiled op run inside, a dict of its name, input
    and output bounds and each output tile's height and width."""
    global _TRACE
    prev, _TRACE = _TRACE, []
    try:
        yield _TRACE
    finally:
        _TRACE = prev


class Tiled:
    """One NHWC activation as a grid of tiles (``tiles[i][j]``, each on
    its own device), tile ``(i, j)`` owning rows ``rows[i]:rows[i + 1]``
    and columns ``cols[j]:cols[j + 1]`` of the frame.  ``home`` is the
    device the frame is gathered on."""

    def __init__(self, tiles: List[List[torch.Tensor]], rows: Bounds,
                 cols: Bounds, home: torch.device):
        self.tiles, self.rows, self.cols, self.home = tiles, rows, cols, home

    @property
    def height(self) -> int:
        return self.rows[-1]

    @property
    def width(self) -> int:
        return self.cols[-1]

    @property
    def batch(self) -> int:
        return self.tiles[0][0].shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles[0][0].dtype

    def indices(self):
        return [(i, j) for i in range(len(self.rows) - 1)
                for j in range(len(self.cols) - 1)]

    def map(self, fn: Callable, *others: "Tiled") -> "Tiled":
        """An elementwise ``fn`` tile by tile (``others`` share the
        bounds): the bounds stay."""
        return Tiled([[fn(t, *(o.tiles[i][j] for o in others))
                       for j, t in enumerate(row)]
                      for i, row in enumerate(self.tiles)],
                     self.rows, self.cols, self.home)

    def window(self, i: int, j: int, r0: int, r1: int, c0: int, c1: int,
               pad_value=None) -> torch.Tensor:
        """Rows ``[r0, r1)`` and columns ``[c0, c1)`` of the frame on tile
        ``(i, j)``'s device, fetched from every tile that owns a part of
        them.  Positions past the frame's edge are filled with
        ``pad_value``; with None they are left out (the window is clamped
        to the frame)."""
        global COPIES, BYTES
        dev = self.tiles[i][j].device
        a0, a1 = max(r0, 0), min(r1, self.height)
        b0, b1 = max(c0, 0), min(c1, self.width)
        if a1 <= a0 or b1 <= b0:
            raise ValueError("window rows [{}, {}) x cols [{}, {}) lies "
                             "outside the {}x{} frame".format(
                                 r0, r1, c0, c1, self.height, self.width))
        bands = []
        for a in range(len(self.rows) - 1):
            lo, hi = max(a0, self.rows[a]), min(a1, self.rows[a + 1])
            if hi <= lo:
                continue
            parts = []
            for b in range(len(self.cols) - 1):
                left, right = max(b0, self.cols[b]), min(b1, self.cols[b + 1])
                if right <= left:
                    continue
                t = self.tiles[a][b]
                piece = t[:, lo - self.rows[a]:hi - self.rows[a],
                          left - self.cols[b]:right - self.cols[b]]
                if (a, b) != (i, j):
                    COPIES += 1
                    BYTES += piece.numel() * piece.element_size()
                    if piece.device != dev:
                        piece = piece.to(dev)
                parts.append(piece)
            bands.append(parts[0] if len(parts) == 1
                         else torch.cat(parts, dim=2))
        x = bands[0] if len(bands) == 1 else torch.cat(bands, dim=1)
        pads = (b0 - c0, c1 - b1, a0 - r0, r1 - a1)
        if pad_value is not None and any(pads):
            x = F.pad(x, (0, 0) + pads, value=pad_value)
        return x

    def gather(self) -> torch.Tensor:
        """The whole frame on the home device (empty tiles drop out)."""
        bands = []
        for row in self.tiles:
            parts = [t if t.device == self.home else t.to(self.home)
                     for t in row]
            bands.append(parts[0] if len(parts) == 1
                         else torch.cat(parts, dim=2))
        return bands[0] if len(bands) == 1 else torch.cat(bands, dim=1)


def tile_op(x: Tiled, rows: Bounds, cols: Bounds, fn: Callable,
            name: str) -> Tiled:
    """A :class:`Tiled` output with bounds ``rows`` x ``cols`` whose tile
    ``(i, j)`` is ``fn(i, j, (q0, q1), (p0, p1))`` for the rows and
    columns it owns; a tile that owns none is an empty tensor of the
    others' channels on its device (``fn`` is not called for it)."""
    out = [[None] * (len(cols) - 1) for _ in range(len(rows) - 1)]
    ref = None
    for i, j in x.indices():
        q, p = (rows[i], rows[i + 1]), (cols[j], cols[j + 1])
        if q[1] > q[0] and p[1] > p[0]:
            out[i][j] = ref = fn(i, j, q, p)
    if ref is None:
        raise ValueError("{}: every tile is empty".format(name))
    for i, j in x.indices():
        if out[i][j] is None:
            out[i][j] = ref.new_empty(
                (ref.shape[0], rows[i + 1] - rows[i], cols[j + 1] - cols[j],
                 ref.shape[3]), device=x.tiles[i][j].device)
    y = Tiled(out, rows, cols, x.home)
    if _TRACE is not None:
        _TRACE.append({
            "op": name, "in_rows": x.rows, "in_cols": x.cols, "rows": rows,
            "cols": cols, "heights": [[t.shape[1] for t in r] for r in out],
            "widths": [[t.shape[2] for t in r] for r in out]})
    return y


def windowed(inputs: Sequence[Tiled], fn: Callable, kernel, stride,
             padding: str, pad_value, name: str) -> Tiled:
    """The op ``fn(*windows)`` of ``kernel`` (kh, kw) and ``stride`` with
    TF ``padding`` over ``inputs`` (tiled alike: a conv over a virtual
    concat takes two), each tile's windows fetched from their owners and
    padded with ``pad_value`` at the frame's edges; ``fn`` runs the op
    VALID on them."""
    x = inputs[0]
    (kh, kw), (sh, sw) = _pair(kernel), _pair(stride)
    rows = next_bounds(x.rows, sh, _out_geometry(x.height, kh, sh,
                                                 padding)[0])
    cols = next_bounds(x.cols, sw, _out_geometry(x.width, kw, sw,
                                                 padding)[0])

    def tile(i, j, q, p):
        r0, r1 = op_window(*q, x.height, kh, sh, padding)
        c0, c1 = op_window(*p, x.width, kw, sw, padding)
        return fn(*(t.window(i, j, r0, r1, c0, c1, pad_value)
                    for t in inputs))
    return tile_op(x, rows, cols, tile, name)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def lowest(dtype: torch.dtype):
    """The max-pool's pad value for ``dtype``: below every value."""
    if dtype.is_floating_point:
        return -float("inf")
    return torch.iinfo(dtype).min


@dataclass(frozen=True)
class Tiling:
    """A grid of ``n_h x n_w`` tiles and the device of each, row-major."""

    n_h: int
    n_w: int
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if self.n_h < 1 or self.n_w < 1 or \
                len(self.devices) != self.n_h * self.n_w:
            raise ValueError("a {}x{} tiling needs {} devices, got {}".format(
                self.n_h, self.n_w, self.n_h * self.n_w, len(self.devices)))

    @property
    def size(self) -> int:
        return self.n_h * self.n_w

    def split(self, images: torch.Tensor, grid_h: int,
              grid_w: int) -> Tiled:
        """``images`` [B, H, W, C] (on its home device) as tiles on their
        devices, cut on the boundaries of a ``grid_h x grid_w`` output
        grid (:func:`image_bounds`)."""
        _, h, w, _ = images.shape
        rows = image_bounds(h, grid_h, self.n_h)
        cols = image_bounds(w, grid_w, self.n_w)
        tiles = [[images[:, rows[i]:rows[i + 1], cols[j]:cols[j + 1]]
                  .to(self.devices[i * self.n_w + j]).contiguous()
                  for j in range(self.n_w)] for i in range(self.n_h)]
        return Tiled(tiles, rows, cols, images.device)
