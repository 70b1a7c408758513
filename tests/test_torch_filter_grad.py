"""K2 (filter gradient) in the port: the plain version against the JAX
package's Pallas kernel (interpret mode) and torch's own conv weight
gradient on the CPU, the routing through ``layers.conv2d`` and
``conv2d_pair``, and the CUDA kernel against the plain version on a GPU.

The GPU case runs where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_filter_grad.py``
so the JAX package is imported only inside the tests that use it.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from squeezedet_torch.models import layers as TL
from squeezedet_torch.ops import filter_grad as fg
from torch_threads import one_thread  # noqa: F401  (autouse)

# the five shapes of tests/test_filter_grad.py
SHAPES = [(1, 1, 4, 4), (1, 1, 5, 7), (3, 3, 6, 10), (3, 3, 5, 7),
          (5, 5, 9, 11)]


def _inputs(rng, b, h, w, c, o):
    return (rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, h, w, o).astype(np.float32))


def _torch_weight_grad(x, dy, kh, kw):
    """torch's conv weight gradient, as [kh, kw, C, O]."""
    c, o = x.shape[-1], dy.shape[-1]
    xt = torch.from_numpy(x).double().permute(0, 3, 1, 2)
    dyt = torch.from_numpy(dy).double().permute(0, 3, 1, 2)
    dw = torch.nn.grad.conv2d_weight(xt, (o, c, kh, kw), dyt,
                                     padding=((kh - 1) // 2, (kw - 1) // 2))
    return dw.permute(2, 3, 1, 0).numpy()


@pytest.fixture
def restore_mode():
    yield
    TL.set_filter_grad(False)


@pytest.mark.parametrize("kh,kw,h,w", SHAPES)
def test_plain_k2_matches_pallas_and_torch(rng, kh, kw, h, w):
    """Against the Pallas kernel (interpret) to rtol 1e-5 / atol 1e-4, the
    tolerance of tests/test_filter_grad.py, and against torch's f64
    weight gradient to 1e-4 (f32 sums of up to 2*11*9 terms of N(0,1)
    products)."""
    import jax.numpy as jnp

    from squeezedet_tpu.ops.filter_grad import filter_grad as jax_fg
    x, dy = _inputs(rng, 2, h, w, 128, 128)
    launches = fg.LAUNCHES
    got = fg.filter_grad(torch.from_numpy(x), torch.from_numpy(dy), kh, kw)
    assert fg.LAUNCHES == launches  # a CPU tensor never launches
    assert got.dtype == torch.float32 and got.shape == (kh, kw, 128, 128)
    want = np.asarray(jax_fg(jnp.asarray(x), jnp.asarray(dy), kh=kh, kw=kw,
                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _torch_weight_grad(x, dy, kh, kw),
                               rtol=1e-5, atol=1e-4)


def test_plain_k2_bf16_widens_exactly(rng):
    """bf16 operands: products of two bf16 values are exact in f32, so the
    bf16 call equals the f32 call on the bf16-rounded operands bit for
    bit, and stays within bf16 rounding (2^-8 relative per operand) of
    the f32 result."""
    x, dy = _inputs(rng, 2, 6, 10, 128, 64)
    xb, dyb = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    got = fg.filter_grad(xb, dyb, 3, 3)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, fg.filter_grad(xb.float(), dyb.float(),
                                                   3, 3), rtol=0, atol=0)
    f32 = fg.filter_grad(torch.from_numpy(x), torch.from_numpy(dy), 3, 3)
    scale = fg.filter_grad(torch.from_numpy(np.abs(x)),
                           torch.from_numpy(np.abs(dy)), 3, 3)
    assert ((got - f32).abs() <= 2 * 2.0 ** -8 * scale + 1e-6).all()


@pytest.mark.parametrize("bad", ["rank", "batch", "even", "dtype", "mixed",
                                 "device"])
def test_k2_rejects_what_the_kernel_does_not_take(bad):
    x, dy, kh, kw = torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 2), 3, 3
    if bad == "rank":
        x = torch.zeros(4, 4, 8)
    elif bad == "batch":
        dy = torch.zeros(2, 4, 4, 2)
    elif bad == "even":
        kh = 2
    elif bad == "dtype":
        x, dy = x.half(), dy.half()
    elif bad == "mixed":
        dy = dy.bfloat16()
    else:
        x, dy = x.to("meta"), dy.to("meta")
    with pytest.raises((ValueError, TypeError)):
        fg.filter_grad(x, dy, kh, kw)


def test_split_k_covers_every_position():
    """bf16 split-K: the splits cover every box (and so every position)
    of a tile once, in chunks of at least MIN_WALK boxes (unless one split
    takes them all), and their groups fit the kernel's arrival
    counters."""
    for boxes, tiles in [(1200, 1), (5120, 1), (300, 27), (1920, 27),
                         (470, 72), (1, 1), (7, 9), (100, 72), (33, 1000)]:
        splits, chunk, group = fg.split_k(boxes, tiles, 40960, 49152)
        assert 1 <= splits and splits * chunk >= boxes > (splits - 1) * chunk
        assert chunk >= fg.MIN_WALK or splits == 1
        assert group == math.isqrt(splits - 1) + 1
        assert -(-splits // group) <= fg.COUNTERS - 1


# (B, kh, kw, H, W, C, O): the train step's routed convs at B=20 and 128,
# the odd shapes, a C and an O that leave ragged tiles, and 1x1 calls that
# run the mma.sync kernel with two C tiles and with two O tiles
PLAN_SHAPES = [(20, 1, 1, 48, 156, 128, 32), (128, 1, 1, 48, 156, 128, 32),
               (20, 3, 3, 24, 78, 384, 72), (128, 3, 3, 24, 78, 384, 72),
               (128, 1, 1, 24, 78, 384, 96), (2, 5, 5, 9, 11, 128, 128),
               (1, 1, 1, 1, 1, 8, 8), (2, 3, 3, 5, 7, 200, 136),
               (20, 1, 1, 24, 78, 256, 96), (20, 1, 1, 45, 153, 128, 256)]
# (calls, kh, C, O, H, W) of the other backbones' routed convs, as
# chip_smoke.K2_BACKBONE_SHAPES lists them
BACKBONE_SHAPES = [
    (2, 1, 128, 192, 45, 153), (2, 1, 128, 288, 45, 153),
    (1, 1, 384, 256, 45, 153), (1, 3, 384, 256, 45, 153),
    (6, 1, 256, 384, 22, 76), (3, 1, 384, 256, 22, 76),
    (3, 3, 384, 256, 22, 76), (2, 3, 256, 72, 22, 76),
    (1, 3, 128, 256, 94, 311), (2, 3, 256, 256, 94, 311),
    (1, 3, 256, 512, 47, 156), (2, 3, 512, 512, 47, 156),
    (3, 3, 512, 512, 24, 78), (1, 3, 512, 72, 24, 78),
    (1, 3, 1024, 72, 24, 78)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_position_tap_and_tile(shape, dtype):
    """The launch plan covers every (C tile, O tile) of every tap once,
    and every position once.  bf16's small 1x1 calls (mma.sync): chunks
    of whole steps of 32 positions within the grid's 65535 limit, never
    past one wave.  bf16 otherwise (TMA + wgmma) and f32 (TMA + CUDA
    cores): boxes that tile the images (bf16: of a multiple of 16
    positions), each box dimension at most 256 (TMA's limit), a ring that
    fits the shared memory a block may use (f32: half an SM's, less the
    block's reserved 1 KB, for 2 blocks an SM) and splits that cover
    every box once; f32 never more splits (so never a larger workspace)
    than the scalar-load f32 kernel's plan, whose 64 x 64 tiles split in
    chunks of 32 positions only while blocks are short of its target."""
    b, kh, kw, h, w, c, o = shape
    dt = getattr(torch, dtype)
    route = fg.ROUTES[dt]
    p = fg.plan(b, h, w, c, o, kh, kw, dt)
    small = kh == kw == 1 and o <= fg.MMA_MAX_O and (
        c <= fg.MMA_TILE or c <= 2 * fg.MMA_TILE
        and -(-o // 128) * b * h * w <= fg.MMA_MAX_POSITIONS)
    if dt == torch.float32:
        assert p.kernel == (3 if c % 4 == 0 and o % 4 == 0 else 0)
        old = fg.cuda_core_plan(b, h, w, c, o, kh, kw)
        assert old.kernel == 0 and old.tile_c == old.tile_o == 64
        assert old.chunk % 32 == 0 and 1 <= old.splits <= 65535
        assert old.splits * old.chunk >= b * h * w > (
            (old.splits - 1) * old.chunk)
        assert old.splits == 1 or old.tiles * (
            old.splits - 1) < fg.F32_TARGET_BLOCKS
        assert p.splits <= old.splits
    else:
        assert p.kernel == (2 if small else 1)
    assert p.tile_c == route.tile_c and p.tile_o in route.widths
    tiles_c, tiles_o = -(-c // p.tile_c), -(-o // p.tile_o)
    assert tiles_c * p.tile_c >= c > (tiles_c - 1) * p.tile_c
    assert tiles_o * p.tile_o >= o > (tiles_o - 1) * p.tile_o
    assert p.tiles == tiles_c * tiles_o * kh * kw
    if p.kernel == 2:
        positions = b * h * w
        assert p.chunk % 32 == 0 and 1 <= p.splits <= 65535
        assert p.splits * p.chunk >= positions > (p.splits - 1) * p.chunk
        assert p.tiles * p.splits <= fg.MMA_WAVE
        return
    assert 1 <= p.hbox <= 256 and 1 <= p.wbox <= 256
    ny, nx = -(-h // p.hbox), -(-w // p.wbox)
    assert ny * p.hbox >= h > (ny - 1) * p.hbox
    assert nx * p.wbox >= w > (nx - 1) * p.wbox
    if p.kernel == 3:
        assert p.tile_o == fg.f32_width(o) and p.group == 1
        assert fg.F32_MIN_STAGES <= p.stages <= fg.MAX_STAGES
        ring = p.stages * fg.f32_stage_bytes(p.hbox * p.wbox, p.tile_o)
        assert ring + 128 + 64 <= 232448 // 2 - 1024
    else:
        assert p.wbox % 16 == 0
        stage = (2 + -(-p.tile_o // 64)) * p.hbox * p.wbox * fg.BOX_BYTES
        assert 2 <= p.stages <= fg.MAX_STAGES
        assert p.stages * stage + 1024 + 256 <= 232448
    boxes = b * ny * nx
    assert p.splits * p.chunk >= boxes > (p.splits - 1) * p.chunk
    if p.kernel == 1:
        assert -(-p.splits // p.group) <= fg.COUNTERS - 1


def _ws_traffic(p, kh, kw, c, o):
    """Bytes of the bf16 workspace written and read back once: the splits'
    partials and (wgmma) the groups' sums of every tile (their C x O
    part)."""
    if p.splits == 1:
        return 0
    groups = -(-p.splits // p.group)
    sums = groups if p.kernel == 1 and groups > 1 else 0
    return 2 * 4 * (p.splits + sums) * kh * kw * c * o


def test_bf16_plan_bounds_the_workspace():
    """At B=128 the bf16 route's split-K workspace traffic (f32 partials
    and group sums written once and read back once) stays under 20 % of
    the operands' bytes at the train shapes."""
    for b, kh, kw, h, w, c, o in [PLAN_SHAPES[i] for i in (1, 3, 4)]:
        p = fg.plan(b, h, w, c, o, kh, kw, torch.bfloat16)
        ws = _ws_traffic(p, kh, kw, c, o)
        assert ws < 0.2 * 2 * b * h * w * (c + o), (b, kh, c, o, ws)


def _walk_bf16_plan(x, dy, kh, kw):
    """The bf16 kernel's walk of its plan in plain torch (f32).  wgmma:
    block (split, tile) sums its run of boxes, X's box shifted by the tap
    and read as zero outside the image, dY's read as zero past it; a
    tile's splits are summed in groups of ``group``, then the groups'
    sums, each in order.  mma.sync (1x1): block (tile, split) sums its
    chunk of positions; the splits are summed in order."""
    b, h, w, c = x.shape
    o = dy.shape[-1]
    p = fg.plan(b, h, w, c, o, kh, kw, torch.bfloat16)
    n, m = p.tile_o, p.tile_c
    tiles_c, tiles_o = -(-c // m), -(-o // n)
    if p.kernel == 2:
        xs = F.pad(x, (0, tiles_c * m - c)).reshape(-1, tiles_c * m)
        ds = F.pad(dy, (0, tiles_o * n - o)).reshape(-1, tiles_o * n)
        out = torch.zeros(1, 1, tiles_c * m, tiles_o * n)
        walked = torch.zeros(xs.shape[0], dtype=torch.int32)
        for ct in range(tiles_c):
            for ot in range(tiles_o):
                total = torch.zeros(m, n)
                for s in range(p.splits):
                    rows = slice(s * p.chunk, (s + 1) * p.chunk)
                    walked[rows] += 1
                    total = total + (xs[rows, ct * m:(ct + 1) * m].T
                                     @ ds[rows, ot * n:(ot + 1) * n])
                out[0, 0, ct * m:(ct + 1) * m, ot * n:(ot + 1) * n] = total
        assert (walked == tiles_c * tiles_o).all()  # once a tile
        return out[:, :, :c, :o]
    ny, nx = -(-h // p.hbox), -(-w // p.wbox)
    boxes = b * ny * nx
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xz = F.pad(x, (0, tiles_c * m - c, pw, pw + p.wbox, ph, ph + p.hbox))
    dz = F.pad(dy, (0, tiles_o * n - o, 0, p.wbox, 0, p.hbox))
    out = torch.zeros(kh, kw, tiles_c * m, tiles_o * n)
    walked = torch.zeros(p.tiles, boxes, dtype=torch.int32)
    for t in range(p.tiles):
        ct, ot, tap = t % tiles_c, t // tiles_c % tiles_o, t // (
            tiles_c * tiles_o)
        i, j = divmod(tap, kw)
        partials = []
        for s in range(p.splits):
            acc = torch.zeros(m, n)
            for box in range(s * p.chunk, min((s + 1) * p.chunk, boxes)):
                walked[t, box] += 1
                bi, y0, x0 = (box // (ny * nx), box // nx % ny * p.hbox,
                              box % nx * p.wbox)
                xb = xz[bi, y0 + i:y0 + i + p.hbox, x0 + j:x0 + j + p.wbox,
                        ct * m:(ct + 1) * m]
                db = dz[bi, y0:y0 + p.hbox, x0:x0 + p.wbox,
                        ot * n:(ot + 1) * n]
                acc += xb.reshape(-1, m).T @ db.reshape(-1, n)
            partials.append(acc)
        groups = []
        for g0 in range(0, p.splits, p.group):
            total = torch.zeros(m, n)
            for part in partials[g0:g0 + p.group]:
                total = total + part
            groups.append(total)
        total = torch.zeros(m, n)
        for part in groups:
            total = total + part
        out[i, j, ct * m:(ct + 1) * m, ot * n:(ot + 1) * n] = total
    assert (walked == 1).all()  # every box of every tile, once
    return out[:, :, :c, :o]


WALK_SHAPES = ([(min(s[0], 2),) + s[1:] for s in PLAN_SHAPES]
               + [(1, kh, kh, h, w, c, o)
                  for _, kh, c, o, h, w in BACKBONE_SHAPES])


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_bf16_plan_walk_equals_plain_k2(shape):
    """The bf16 plan (boxes, splits and summation tree, or chunks of
    positions), walked in plain torch on the CPU at the train, odd,
    ragged and backbone shapes (small batch), gives the plain K2 within
    1e-5 of sum|x|*|dy| per output (f32 sums in another order): the
    geometry the kernels' loads follow, checked where no kernel runs."""
    b, kh, kw, h, w, c, o = shape
    x, dy = _inputs(np.random.RandomState(5), b, h, w, c, o)
    x, dy = torch.from_numpy(x), torch.from_numpy(dy)
    got = _walk_bf16_plan(x, dy, kh, kw)
    want = fg.filter_grad_reference(x, dy, kh, kw)
    scale = fg.filter_grad_reference(x.abs(), dy.abs(), kh, kw)
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


# (calls, kh, C, O, H, W) of the train step's routed convs at 1248x384, as
# chip_smoke.K2_TRAIN_SHAPES lists them
TRAIN_SHAPES = [(2, 1, 128, 32, 48, 156), (2, 1, 128, 48, 24, 78),
                (2, 1, 256, 64, 24, 78), (2, 1, 256, 96, 24, 78),
                (2, 1, 384, 96, 24, 78), (2, 3, 384, 72, 24, 78)]


def test_f32_plan_fits_o_and_bounds_the_workspace():
    """At every model shape (the train step's at B=20 and 128, the other
    backbones' at their config batch) the f32 TMA plan puts at most 12 %
    of its multiply-adds on padding (ragged tiles, boxes past the image)
    and its split-K workspace is no larger than the scalar-load f32
    kernel's."""
    cases = ([(b,) + s for b in (20, 128) for s in TRAIN_SHAPES]
             + [(5 if 256 <= s[3] <= 512 and s[4] in (94, 47) else 20,) + s
                for s in BACKBONE_SHAPES])
    for b, _, kh, c, o, h, w in cases:
        p = fg.plan(b, h, w, c, o, kh, kh, torch.float32)
        assert p.kernel == 3
        assert fg.padding_share(p, b, h, w, c, o) <= 0.12, (b, kh, c, o)
        old = fg.cuda_core_plan(b, h, w, c, o, kh, kh)
        assert (fg.workspace_words(p, kh, kh, c, o)
                <= fg.workspace_words(old, kh, kh, c, o))


def _walk_f32_plan(x, dy, kh, kw):
    """The f32 kernels' walk of their plan in plain torch.  TMA kernel:
    block (split, tile) sums its run of boxes, X's 128-channel box
    shifted by the tap and read as zero outside the image, dY's tile_o
    columns read as zero past it; the scalar-load kernel (C % 4 or O % 4 not
    0): block (tile, split) sums its chunk of positions of 64 x 64 tiles.
    Either way the splits' partials are then summed in split order."""
    b, h, w, c = x.shape
    o = dy.shape[-1]
    p = fg.plan(b, h, w, c, o, kh, kw, torch.float32)
    m, n = p.tile_c, p.tile_o
    tiles_c, tiles_o = -(-c // m), -(-o // n)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    out = torch.zeros(kh, kw, tiles_c * m, tiles_o * n)
    if p.kernel == 0:
        xz = F.pad(x, (0, tiles_c * m - c, pw, pw, ph, ph))
        ds = F.pad(dy, (0, tiles_o * n - o)).reshape(-1, tiles_o * n)
        walked = torch.zeros(kh * kw, ds.shape[0], dtype=torch.int32)
        for tap in range(kh * kw):
            i, j = divmod(tap, kw)
            xs = xz[:, i:i + h, j:j + w].reshape(-1, tiles_c * m)
            for ct in range(tiles_c):
                for ot in range(tiles_o):
                    total = torch.zeros(m, n)
                    for s in range(p.splits):
                        rows = slice(s * p.chunk, (s + 1) * p.chunk)
                        if ct == ot == 0:
                            walked[tap, rows] += 1
                        total = total + (xs[rows, ct * m:(ct + 1) * m].T
                                         @ ds[rows, ot * n:(ot + 1) * n])
                    out[i, j, ct * m:(ct + 1) * m,
                        ot * n:(ot + 1) * n] = total
        assert (walked == 1).all()  # every position of every tap, once
        return out[:, :, :c, :o]
    assert p.kernel == 3
    ny, nx = -(-h // p.hbox), -(-w // p.wbox)
    boxes = b * ny * nx
    xz = F.pad(x, (0, tiles_c * m - c, pw, pw + p.wbox, ph, ph + p.hbox))
    dz = F.pad(dy, (0, tiles_o * n - o, 0, p.wbox, 0, p.hbox))
    walked = torch.zeros(p.tiles, boxes, dtype=torch.int32)
    for t in range(p.tiles):
        ct, ot, tap = t % tiles_c, t // tiles_c % tiles_o, t // (
            tiles_c * tiles_o)
        i, j = divmod(tap, kw)
        total = torch.zeros(m, n)
        for s in range(p.splits):
            acc = torch.zeros(m, n)
            for box in range(s * p.chunk, min((s + 1) * p.chunk, boxes)):
                walked[t, box] += 1
                bi, y0, x0 = (box // (ny * nx), box // nx % ny * p.hbox,
                              box % nx * p.wbox)
                xb = xz[bi, y0 + i:y0 + i + p.hbox, x0 + j:x0 + j + p.wbox,
                        ct * m:(ct + 1) * m]
                db = dz[bi, y0:y0 + p.hbox, x0:x0 + p.wbox,
                        ot * n:(ot + 1) * n]
                acc += xb.reshape(-1, m).T @ db.reshape(-1, n)
            total = total + acc
        out[i, j, ct * m:(ct + 1) * m, ot * n:(ot + 1) * n] = total
    assert (walked == 1).all()  # every box of every tile, once
    return out[:, :, :c, :o]


@pytest.mark.parametrize("shape", [(2, 1, 1, 6, 10, 128, 32),
                                   (2, 3, 3, 5, 7, 128, 72),
                                   (2, 5, 5, 9, 11, 64, 96),
                                   (2, 3, 3, 4, 6, 128, 30)])
def test_f32_plan_walk_equals_pallas(shape):
    """The f32 plan walked in plain torch on the CPU (1x1, 3x3 and 5x5;
    O = 32, 72 and 96 on the TMA kernel, a ragged C tile, and O = 30,
    which no tensor map describes, on the scalar-load kernel) against the JAX
    package's Pallas kernel in interpret mode: rtol 1e-5 / atol 1e-4,
    the tolerance of tests/test_filter_grad.py."""
    import jax.numpy as jnp

    from squeezedet_tpu.ops.filter_grad import filter_grad as jax_fg
    b, kh, kw, h, w, c, o = shape
    x, dy = _inputs(np.random.RandomState(7), b, h, w, c, o)
    got = _walk_f32_plan(torch.from_numpy(x), torch.from_numpy(dy), kh, kw)
    want = np.asarray(jax_fg(jnp.asarray(x), jnp.asarray(dy), kh=kh, kw=kw,
                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_f32_plan_walk_equals_plain_k2_at_train_shapes(shape):
    """The f32 plan walked at the train step's conv shapes (B=1): within
    1e-5 of sum|x|*|dy| per output of the plain K2 (f32 sums in another
    order)."""
    _, kh, c, o, h, w = shape
    x, dy = _inputs(np.random.RandomState(8), 1, h, w, c, o)
    x, dy = torch.from_numpy(x), torch.from_numpy(dy)
    got = _walk_f32_plan(x, dy, kh, kh)
    want = fg.filter_grad_reference(x, dy, kh, kh)
    scale = fg.filter_grad_reference(x.abs(), dy.abs(), kh, kh)
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


@pytest.mark.parametrize("bad", ["c", "o", "x_offset", "dy_offset",
                                 "strided"])
def test_bf16_kernel_refuses_layouts_it_does_not_take(bad):
    """What the tensor-core route needs (C % 8, O % 8, 16-byte aligned
    x and dy, contiguous NHWC) is checked before any launch; f32 takes
    any C and O."""
    def view(shape, offset=0):
        n = int(np.prod(shape))
        return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(
            shape)
    x, dy = view((2, 4, 4, 16)), view((2, 4, 4, 8))
    fg.check_kernel_layout(x, dy)
    fg.check_kernel_layout(torch.zeros(2, 4, 4, 12), torch.zeros(2, 4, 4, 5))
    if bad == "c":
        x = view((2, 4, 4, 12))
    elif bad == "o":
        dy = view((2, 4, 4, 12))
    elif bad == "x_offset":
        x = view((2, 4, 4, 16), offset=4)
    elif bad == "dy_offset":
        dy = view((2, 4, 4, 8), offset=2)
    else:
        x = view((2, 4, 4, 32))[..., :16]
    with pytest.raises(ValueError):
        fg.check_kernel_layout(x, dy)


def _routing_case(rng, pair):
    c = 256 if pair else 128
    kern = (rng.randn(64, c, 3, 3) * 0.1).astype(np.float32)
    conv = TL.Conv(torch.from_numpy(kern), torch.from_numpy(
        (rng.randn(64) * 0.1).astype(np.float32)))
    xs = [torch.from_numpy(rng.randn(2, 6, 10, 128).astype(np.float32))
          .requires_grad_() for _ in range(2 if pair else 1)]

    def grads():
        for t in [conv.weight, conv.bias] + xs:
            t.grad = None
        if pair:
            y = TL.conv2d_pair(conv, xs[0], xs[1], 1)
        else:
            y = TL.conv2d(conv, xs[0], 1)
        torch.sum(y * y).backward()
        return [t.grad.clone() for t in [conv.weight, conv.bias] + xs]
    return grads


@pytest.mark.parametrize("pair", [False, True], ids=["conv2d", "conv2d_pair"])
def test_conv_routing_matches_autograd(rng, restore_mode, pair):
    """dW, db and dX through the K2 Function equal autograd with the mode
    off, to rtol 1e-5 / atol 1e-4 (mirrors test_conv2d_custom_vjp_routing
    and its _pair_ twin)."""
    grads = _routing_case(rng, pair)
    ref = grads()
    calls = []
    real = fg.filter_grad

    def spy(*args):
        calls.append(args[2:])
        return real(*args)
    fg.filter_grad = spy
    try:
        TL.set_filter_grad(True)
        got = grads()
    finally:
        fg.filter_grad = real
    assert calls == [(3, 3)] * (2 if pair else 1)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-4)


def test_ineligible_convs_stay_on_autograd(restore_mode):
    """C % 128 != 0, even kernels, the mode off, and non-1x1 or
    non-16-aligned convs in "1x1" mode never route (mirrors
    test_ineligible_convs_stay_on_xla)."""
    x = torch.zeros(2, 6, 10, 64)
    x128 = torch.zeros(2, 6, 10, 128)
    x128_16 = torch.zeros(2, 4, 8, 128)
    k = torch.zeros(64, 64, 3, 3)
    assert not TL.filter_grad_eligible(x128, torch.zeros(64, 128, 3, 3))
    TL.set_filter_grad(True)
    assert not TL.filter_grad_eligible(x, k)  # C % 128 != 0
    assert not TL.filter_grad_eligible(x128, torch.zeros(64, 128, 2, 2))
    assert TL.filter_grad_eligible(x128, torch.zeros(64, 128, 3, 3))
    assert TL.filter_grad_eligible(x128, torch.zeros(64, 128, 1, 1))
    TL.set_filter_grad("1x1")
    assert not TL.filter_grad_eligible(x128_16, torch.zeros(64, 128, 3, 3))
    assert not TL.filter_grad_eligible(x128, torch.zeros(64, 128, 1, 1))
    assert TL.filter_grad_eligible(x128_16, torch.zeros(64, 128, 1, 1))
    with pytest.raises(ValueError):
        TL.set_filter_grad("interpret")
    # the bf16 (tensor-core) route takes O % 8 == 0 only; f32 takes any O
    TL.set_filter_grad(True)
    xb = x128.bfloat16()
    assert TL.filter_grad_eligible(xb, torch.zeros(72, 128, 3, 3))
    assert not TL.filter_grad_eligible(xb, torch.zeros(36, 128, 3, 3))
    assert TL.filter_grad_eligible(x128, torch.zeros(36, 128, 3, 3))
    # stride-2 and VALID convs never take K2, whatever the mode
    TL.set_filter_grad(True)
    conv = TL.Conv(torch.ones(8, 128, 3, 3), torch.zeros(8))
    real, calls = fg.filter_grad, []
    fg.filter_grad = lambda *a: calls.append(a) or real(*a)
    try:
        for stride, padding in [(2, "SAME"), (1, "VALID")]:
            TL.conv2d(conv, x128 + 1, stride, padding).sum().backward()
    finally:
        fg.filter_grad = real
    assert calls == [] and conv.weight.grad.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,kw,h,w", SHAPES)
def test_cuda_k2_matches_plain(kh, kw, h, w, dtype):
    """CUDA kernel vs the plain version on the card (TF32 off): within
    1e-5 of sum|x|*|dy| per output (f32 sums in different orders), and
    two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dy = _inputs(np.random.RandomState(0), 2, h, w, 128, 128)
    dt = getattr(torch, dtype)
    xt, dyt = torch.from_numpy(x).to("cuda", dt), torch.from_numpy(dy).to(
        "cuda", dt)
    launches = fg.LAUNCHES
    got = fg.filter_grad(xt, dyt, kh, kw)
    again = fg.filter_grad(xt, dyt, kh, kw)
    assert fg.LAUNCHES == launches + 2
    want = fg.filter_grad_reference(xt, dyt, kh, kw)
    scale = fg.filter_grad_reference(xt.abs(), dyt.abs(), kh, kw)
    assert torch.equal(got, again)
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kh,c,o,h,w", [(1, 128, 72, 6, 10),
                                        (3, 384, 72, 24, 78),
                                        (1, 256, 96, 9, 11),
                                        (3, 128, 128, 5, 7),
                                        (3, 200, 96, 4, 1),
                                        (3, 72, 8, 1, 3),
                                        (3, 64, 136, 7, 9),
                                        (5, 128, 96, 9, 11),
                                        (1, 8, 136, 3, 5)])
def test_cuda_k2_bf16_tensor_cores_at_ragged_shapes(kh, c, o, h, w):
    """The bf16 route at O = 8, 72, 96, 128 and 136 (a second, ragged O
    tile), a 5x5 tap, C = 8, 72 and 200 (ragged C tiles), conv12's shape,
    and 3x3 kernels on images 1 pixel wide or high (every tap but the
    centre reads outside the image): within 1e-5 of sum|x|*|dy| of the
    plain version, bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dy = _inputs(np.random.RandomState(1), 2, h, w, c, o)
    xt = torch.from_numpy(x).to("cuda", torch.bfloat16)
    dyt = torch.from_numpy(dy).to("cuda", torch.bfloat16)
    got = fg.filter_grad(xt, dyt, kh, kh)
    assert torch.equal(got, fg.filter_grad(xt, dyt, kh, kh))
    want = fg.filter_grad_reference(xt, dyt, kh, kh)
    scale = fg.filter_grad_reference(xt.abs(), dyt.abs(), kh, kh)
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kh,c,o,h,w", [(1, 128, 32, 12, 20),
                                        (1, 128, 48, 6, 10),
                                        (1, 256, 64, 6, 10),
                                        (1, 384, 96, 6, 10),
                                        (3, 384, 72, 24, 78),
                                        (5, 128, 96, 9, 11),
                                        (3, 200, 136, 5, 7),
                                        (3, 64, 30, 5, 7),
                                        (1, 6, 10, 3, 4)])
def test_cuda_k2_f32_routes_at_model_and_ragged_shapes(kh, c, o, h, w):
    """The f32 route on the card (TF32 off): the TMA kernel at O = 32,
    48, 64, 72 and 96 (conv12's shape among them), a 5x5 tap and ragged
    C and O tiles; the scalar-load kernel where no tensor map
    describes the operands (O % 4 or C % 4 not 0) and for operands that
    are not 16-byte aligned: within 1e-5 of sum|x|*|dy| of the plain
    version, bitwise repeatable, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dy = _inputs(np.random.RandomState(3), 2, h, w, c, o)
    xt, dyt = torch.from_numpy(x).cuda(), torch.from_numpy(dy).cuda()
    p = fg.plan(2, h, w, c, o, kh, kh, torch.float32)
    assert p.kernel == (3 if c % 4 == 0 and o % 4 == 0 else 0)
    # the same operands 4 bytes off 16-byte alignment: the scalar-load kernel
    xs = torch.empty(xt.numel() + 1, device="cuda")[1:].view(xt.shape)
    dys = torch.empty(dyt.numel() + 1, device="cuda")[1:].view(dyt.shape)
    xs.copy_(xt)
    dys.copy_(dyt)
    want = fg.filter_grad_reference(xt, dyt, kh, kh)
    scale = fg.filter_grad_reference(xt.abs(), dyt.abs(), kh, kh)
    for a, b in ((xt, dyt), (xs, dys)):
        launches = fg.LAUNCHES
        got = fg.filter_grad(a, b, kh, kh)
        assert torch.equal(got, fg.filter_grad(a, b, kh, kh))
        assert fg.LAUNCHES == launches + 2
        assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
