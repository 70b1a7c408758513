"""K1's f32 route (``conv1_pool1_f32_strip`` in csrc/conv1_pool1.cu): its
launch plan and tiling on the CPU, the kernel itself on a GPU.

The kernel cannot run here, so its design is walked in torch: the plan
(``fused_frontend.f32_plan``, the same function as the kernel's
``f32_plan``), each warp tile's halo window with its zero pads, the conv
rows and columns it computes, the -inf of positions outside the conv
output, the pool on the raw sums and then bias and ReLU.  The walk is
held to the JAX package's Pallas kernel (interpret mode) and to the
plain version; the halo ring's staging order and the tap planes are
replayed on their own.

The GPU cases run where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_k1_f32.py``
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from squeezedet_torch.models import halo
from squeezedet_torch.ops import fused_frontend as ff
from torch_threads import one_thread  # noqa: F401  (autouse)

STRIP = ff.F32_STRIP
HALO_PX = 4 * STRIP + 5  # input pixels of a strip's halo row
RING = 6                 # halo rows of a warp's ring
PLANES = 4               # tap planes of halo rows of a warp


def _tile(t, plan, geo):
    """Warp tile t as the kernel decodes it: image, first pool row and
    column, pool rows, first conv row and column, first input row and
    column."""
    hp = geo[2]
    pt, pl, ppt, ppl = geo[4:]
    rest, strip = divmod(t, plan.strips)
    b, seg = divmod(rest, plan.segs)
    p0, q0 = seg * plan.tile_rows, strip * STRIP
    n = min(plan.tile_rows, hp - p0)
    cr0, cc0 = 2 * p0 - ppt, 2 * q0 - ppl
    return b, p0, q0, n, cr0, cc0, 2 * cr0 - pt, 2 * cc0 - pl


def _tiles(b, geo):
    plan = ff.f32_plan(b, geo[2], geo[3])
    return plan, [_tile(t, plan, geo) for t in range(plan.tiles)]


def _walk(x, k, bias, geo=None):
    """The f32 kernel's tiling in torch: every warp tile's outputs from its
    own zero-padded halo window of 4 n + 3 rows x 65 pixels."""
    b_, h, w, _ = x.shape
    geo = ff.geometry(h, w) if geo is None else tuple(geo)
    hc, wc, hp, wp = geo[:4]
    _, tiles = _tiles(b_, geo)
    out = torch.full((b_, hp, wp, ff.FILTERS), math.nan)
    kt = k.permute(3, 2, 0, 1)
    for b, p0, q0, n, cr0, cc0, ir0, ic0 in tiles:
        win = torch.zeros(4 * n + 3, HALO_PX, 3)
        y0, y1 = max(ir0, 0), min(ir0 + 4 * n + 3, h)
        x0, x1 = max(ic0, 0), min(ic0 + HALO_PX, w)
        if y0 < y1 and x0 < x1:
            win[y0 - ir0:y1 - ir0, x0 - ic0:x1 - ic0] = x[b, y0:y1, x0:x1]
        raw = F.conv2d(win.permute(2, 0, 1)[None], kt, stride=2)[0]
        assert raw.shape == (ff.FILTERS, 2 * n + 1, 32)
        rows_in = (torch.arange(cr0, cr0 + 2 * n + 1) >= 0) & \
            (torch.arange(cr0, cr0 + 2 * n + 1) < hc)
        cols_in = (torch.arange(cc0, cc0 + 32) >= 0) & \
            (torch.arange(cc0, cc0 + 32) < wc)
        raw[:, ~rows_in] = -math.inf
        raw[:, :, ~cols_in] = -math.inf
        m = F.max_pool2d(raw[None], 3, 2)[0]  # [64, n, 15]: raw maxima
        pooled = torch.relu(m + bias.view(-1, 1, 1))
        # a window holding no conv position stays -inf, as in the plain
        # version
        win_r = F.max_pool1d(rows_in.float()[None], 3, 2)[0] > 0
        win_c = F.max_pool1d(cols_in.float()[None], 3, 2)[0] > 0
        pooled[:, ~(win_r[:, None] & win_c[None, :])] = -math.inf
        q1 = min(q0 + STRIP, wp)
        out[b, p0:p0 + n, q0:q1] = pooled[:, :, :q1 - q0].permute(1, 2, 0)
    return out


def _inputs(seed, b, h, w):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, 3).astype(np.float32),
            rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1,
            rng.randn(64).astype(np.float32) * 0.1)


def _windows(h, w, grid):
    """(window, geometry) of every tile of an n_h x n_w spatial grid of an
    h x w frame, as the model's tiled K1 cuts it."""
    hc, wc, hp, wp = ff.geometry(h, w)[:4]
    rows = halo.next_bounds(halo.next_bounds(
        halo.image_bounds(h, h // 16, grid[0]), 2, hc), 2, hp)
    cols = halo.next_bounds(halo.next_bounds(
        halo.image_bounds(w, w // 16, grid[1]), 2, wc), 2, wp)
    return [ff.tile_geometry(h, w, rb, cb)
            for rb in zip(rows, rows[1:]) for cb in zip(cols, cols[1:])]


FRAMES = [(1, 384, 1248), (2, 375, 1242), (128, 384, 1248), (3, 33, 47),
          (1, 9, 5), (1, 2, 2), (2, 70, 131), (1, 1, 1)]
TILE_GEOS = [g for frame, grid in (((384, 1248), (4, 1)),
                                   ((384, 1248), (2, 2)),
                                   ((375, 1242), (3, 2)))
             for _, g in _windows(*frame, grid)]


@pytest.mark.parametrize("geo", [ff.geometry(h, w) for _, h, w in FRAMES]
                         + TILE_GEOS)
@pytest.mark.parametrize("b", [1, 5])
def test_f32_plan_covers_every_pool_output_once(geo, b):
    """The warp tiles' stored outputs (their pool rows, and the strip's
    columns inside the frame) are every pool output of every image once;
    a run is never empty and only an image's last run is short."""
    hp, wp = geo[2], geo[3]
    plan, tiles = _tiles(b, geo)
    assert plan.strips == -(-wp // STRIP) and plan.segs == -(-hp //
                                                              plan.tile_rows)
    assert plan.tiles == b * plan.segs * plan.strips
    assert plan.blocks == -(-plan.tiles // ff.F32_WARPS)
    seen = np.zeros((b, hp, wp), np.int64)
    for bi, p0, q0, n, *_ in tiles:
        assert 1 <= n <= plan.tile_rows
        assert n == plan.tile_rows or p0 + n == hp
        seen[bi, p0:p0 + n, q0:q0 + STRIP] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("geo", [ff.geometry(h, w) for _, h, w in FRAMES[:3]]
                         + TILE_GEOS[:6])
def test_f32_halo_windows_hold_what_the_outputs_read(geo):
    """Through the pool and the conv, the outputs a warp tile stores read
    conv rows [cr0, cr0 + 2n + 1) and its 31 used conv columns, and those
    read input rows [ir0, ir0 + 4n + 3) and its 65 pixels; the image
    parts outside are the zero pads the kernel fills."""
    hc, wc, hp, wp, pt, pl, ppt, ppl = geo
    for b, p0, q0, n, cr0, cc0, ir0, ic0 in _tiles(2, geo)[1]:
        q1 = min(q0 + STRIP, wp)
        crows = [r for p in range(p0, p0 + n) for r in
                 range(2 * p - ppt, 2 * p - ppt + 3) if 0 <= r < hc]
        ccols = [c for q in range(q0, q1) for c in
                 range(2 * q - ppl, 2 * q - ppl + 3) if 0 <= c < wc]
        assert cr0 <= min(crows) and max(crows) < cr0 + 2 * n + 1
        assert cc0 <= min(ccols) and max(ccols) < cc0 + 2 * STRIP + 1
        irows = {2 * r - pt + d for r in crows for d in range(3)}
        icols = {2 * c - pl + d for c in ccols for d in range(3)}
        assert ir0 <= min(irows) and max(irows) < ir0 + 4 * n + 3
        assert ic0 <= min(icols) and max(icols) < ic0 + HALO_PX


@pytest.mark.parametrize("n", range(1, 41))
def test_f32_ring_never_overwrites_a_row_in_use(n):
    """The kernel's staging order for a run of n pool rows, replayed: rows
    0-2 and 3-4 as the first two groups of copies; then for conv row kk,
    wait for all but the newest group, turn rows 2 kk + 1, 2 kk + 2 (and
    0-2 at kk = 0) into tap planes (slot r % 4), issue rows 2 kk + 5,
    2 kk + 6 as a group (slot r % 6), and read the planes of rows 2 kk ..
    2 kk + 2.  Every row turned has landed, a copy only evicts a row
    already turned, and a plane only one no later conv row reads."""
    rows = 4 * n + 3
    raw, planes, turned = {}, {}, set()
    groups = [[0, 1, 2], [3, 4]]
    for r in groups[0] + groups[1]:
        raw[r % RING] = r
    for kk in range(2 * n + 1):
        landed = {r for g in groups[:-1] for r in g}
        for r in ([0, 1, 2] if kk == 0 else [2 * kk + 1, 2 * kk + 2]):
            assert r in landed and raw[r % RING] == r
            old = planes.get(r % PLANES)
            assert old is None or old < 2 * kk  # read by conv rows < kk
            planes[r % PLANES] = r
            turned.add(r)
        group = [r for r in (2 * kk + 5, 2 * kk + 6) if r < rows]
        for r in group:
            assert raw.get(r % RING) in turned | {None}
            raw[r % RING] = r
        groups.append(group)
        for r in range(2 * kk, 2 * kk + 3):
            assert planes[r % PLANES] == r


def test_f32_tap_planes_hold_each_taps_inputs():
    """Halo rows of 65 pixels as the kernel's 9 tap planes, plane (dj, ci)
    holding float 6 c + 3 dj + ci of the row (and its pad float) for conv
    column c: the sum over 3 rows' planes times the taps' weights, in
    (di, dj, ci) order, is the stride-2 conv of the 3 rows at its 32
    columns (to 1e-12, in float64)."""
    rng = np.random.RandomState(5)
    rows = torch.from_numpy(rng.randn(3, HALO_PX, 3))
    k = torch.from_numpy(rng.randn(3, 3, 3, 8))
    flat = torch.cat([rows.reshape(3, -1), torch.zeros(3, 1)], 1)  # + pad
    assert flat.shape == (3, 196)
    c = torch.arange(32)
    planes = torch.stack([flat[:, 6 * c + tap] for tap in range(9)], 1)
    acc = torch.zeros(32, 8, dtype=torch.float64)
    for di in range(3):
        for tap in range(9):
            acc = acc + planes[di, tap][:, None] * k[di, tap // 3,
                                                     tap % 3][None]
    want = F.conv2d(rows.permute(2, 0, 1)[None], k.permute(3, 2, 0, 1),
                    stride=2)[0, :, 0].T  # [32 conv columns, 8]
    torch.testing.assert_close(acc, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("frame", [(384, 1248), (375, 1242)])
def test_f32_plan_fills_the_card_at_batch_1(frame):
    """B=1 frames (the f32 eval and demo forwards) take at least one block
    of 4 warps per SM of the H100; at B=128 a warp walks runs of at least
    8 pool rows, so the conv row two runs share is at most 1/16 more."""
    hp, wp = ff.geometry(*frame)[2:4]
    assert ff.f32_plan(1, hp, wp).blocks >= ff.SMS
    assert ff.f32_plan(128, hp, wp).tile_rows >= 8


@pytest.mark.parametrize("grid", [(2, 1), (4, 1), (2, 2)])
def test_f32_plan_fills_the_card_on_tile_windows(grid):
    """A spatial tile's window at B=1: the plan fills the H100's 528 warp
    schedulers with warp tiles, or, where the window has fewer pool rows x
    strips than that, cuts it into runs of single pool rows."""
    for _, geo in _windows(384, 1248, grid):
        hp, wp = geo[2], geo[3]
        plan = ff.f32_plan(1, hp, wp)
        assert plan.tiles >= min(4 * ff.SMS, hp * plan.strips)


def test_f32_plan_takes_large_calls_in_one_launch():
    """Images of 2^31 elements or more (B=1500 at 384x1248: 2.157e9
    floats) are one launch: the kernel's offsets are 64-bit and its copies
    4 bytes, so no cut is planned and the grid stays under 2^31 blocks."""
    assert 1500 * 384 * 1248 * 3 >= 2 ** 31
    plan = ff.f32_plan(1500, 96, 312)
    assert plan.blocks < 2 ** 31 and plan.tiles == 1500 * plan.segs * 21


def test_pool_before_bias_and_relu_is_bit_exact():
    """The kernel pools raw sums and adds the bias and ReLU once per pooled
    value; the plain order adds them to every sum first.  Both are
    monotonic, so the two agree bit for bit, also at infinities, NaNs,
    signed zeros and values whose sum with the bias rounds."""
    rng = np.random.RandomState(3)
    raw = (rng.randn(4096, 9) * 10.0 ** rng.randint(-40, 39, (4096, 9))
           ).astype(np.float32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-45,
                        3.4e38, -3.4e38], np.float32)
    raw[:512] = rng.choice(special, (512, 9))
    bias = (rng.randn(4096) * 10.0 ** rng.randint(-40, 39, 4096)
            ).astype(np.float32)
    bias[:64] = rng.choice(special, 64)
    raw, bias = torch.from_numpy(raw), torch.from_numpy(bias)[:, None]
    zero = torch.zeros(())
    # fmaxf: the number where one side is NaN, NaN only from two NaNs
    fmax = lambda a, b: torch.fmax(a, b)  # noqa: E731
    plain = fmax(raw + bias, zero)        # relu(sum + b) for every sum
    want = plain[:, 0]
    for i in range(1, 9):
        want = fmax(want, plain[:, i])
    m = raw[:, 0]
    for i in range(1, 9):
        m = fmax(m, raw[:, i])
    got = fmax(m + bias[:, 0], zero)
    same = (got.view(torch.int32) == want.view(torch.int32)) | \
        (got.isnan() & want.isnan())
    assert same.all(), (raw[~same][:4], bias[~same][:4])


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 96, 160),
                                   (1, 32, 1248)])
def test_f32_plan_walk_equals_pallas(shape):
    """The walk against the JAX package's Pallas kernel in interpret mode,
    at the shapes it takes, to 1e-5 (the two sum 27 taps in different
    orders)."""
    import jax.numpy as jnp

    from squeezedet_tpu.ops.fused_frontend import conv1_pool1_fused
    x, k, bias = _inputs(0, *shape)
    want = np.asarray(conv1_pool1_fused(jnp.asarray(x), jnp.asarray(k),
                                        jnp.asarray(bias), interpret=True))
    got = _walk(torch.from_numpy(x), torch.from_numpy(k),
                torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 33, 47), (1, 9, 5), (1, 2, 2),
                                   (2, 70, 131), (1, 1, 1)])
def test_f32_plan_walk_equals_plain_at_odd_shapes(shape):
    """Odd extents (TF SAME pads of 1 on both sides), ragged strips and
    runs, a frame narrower than one strip: the walk against the plain
    version to 1e-5."""
    x, k, bias = (torch.from_numpy(a) for a in _inputs(1, *shape))
    want = ff.conv1_pool1_reference(x, k, bias)
    got = _walk(x, k, bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("frame,grid", [((96, 320), (2, 2)),
                                        ((93, 250), (3, 2)),
                                        ((72, 136), (4, 1))])
def test_f32_plan_walk_equals_plain_on_tile_windows(frame, grid):
    """Each tile window of a spatial grid at its own geometry (leading
    pads only at the frame's edges, a last tile that runs off the
    window): the walk against the plain version to 1e-5."""
    x, k, bias = (torch.from_numpy(a) for a in _inputs(2, 1, *frame))
    for ((r0, r1), (c0, c1)), geo in _windows(*frame, grid):
        win = x[:, r0:r1, c0:c1].contiguous()
        want = ff.conv1_pool1_reference(win, k, bias, list(geo))
        torch.testing.assert_close(_walk(win, k, bias, geo), want,
                                   rtol=1e-5, atol=1e-5)


def test_captured_launches_count_the_f32_route_at_each_replay():
    """Under stream capture a launch only enters the graph: the capture
    takes its count back off ``LAUNCHES`` and ``F32_LAUNCHES`` (and K2's
    ``LAUNCHES``), and each replay adds it again."""
    from squeezedet_torch.ops import _cuda
    from squeezedet_torch.ops import filter_grad as fg
    before = ff.LAUNCHES, ff.F32_LAUNCHES, fg.LAUNCHES
    with _cuda.CapturedLaunches() as captured:
        ff.LAUNCHES += 2  # an f32 forward and a bf16 one
        ff.F32_LAUNCHES += 1
        fg.LAUNCHES += 3
    assert (ff.LAUNCHES, ff.F32_LAUNCHES, fg.LAUNCHES) == before
    for replays in (1, 2):
        captured.replayed()
        assert (ff.LAUNCHES, ff.F32_LAUNCHES, fg.LAUNCHES) == (
            before[0] + 2 * replays, before[1] + replays,
            before[2] + 3 * replays)
    ff.LAUNCHES, ff.F32_LAUNCHES, fg.LAUNCHES = before


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want):
    """K1's f32 tolerance: 1e-4 + 1e-5 * |plain| (chip_smoke.K1_F32_*)."""
    return ((got - want).abs() <= 1e-4 + 1e-5 * want.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 375, 1242), (3, 33, 47), (1, 9, 5),
                                   (1, 2, 2), (1, 70, 131), (1, 1, 1)])
def test_cuda_k1_f32_at_odd_sizes(shape):
    """The f32 kernel at odd extents, ragged strips and runs and a frame
    narrower than a strip: within K1's f32 tolerance of the plain
    version, two launches bitwise equal, each counted as an f32 launch."""
    _card()
    x, k, bias = _inputs(3, *shape)
    xt = torch.from_numpy(x * 50).cuda()
    kt, bt = torch.from_numpy(k).cuda(), torch.from_numpy(bias * 100).cuda()
    before = ff.LAUNCHES, ff.F32_LAUNCHES
    got = ff.conv1_pool1(xt, kt, bt)
    assert torch.equal(got, ff.conv1_pool1(xt, kt, bt))
    assert (ff.LAUNCHES - before[0], ff.F32_LAUNCHES - before[1]) == (2, 2)
    assert _close(got, ff.conv1_pool1_reference(xt, kt, bt))


@pytest.mark.cuda
@pytest.mark.parametrize("frame,grid", [((384, 1248), (2, 2)),
                                        ((384, 1248), (4, 1)),
                                        ((375, 1242), (3, 2))])
def test_cuda_k1_f32_at_tile_windows(frame, grid):
    """Every tile window of a spatial grid at its own geometry: within
    K1's f32 tolerance of the plain version."""
    _card()
    x, k, bias = _inputs(4, 1, *frame)
    xt = torch.from_numpy(x * 50).cuda()
    kt, bt = torch.from_numpy(k).cuda(), torch.from_numpy(bias * 100).cuda()
    for ((r0, r1), (c0, c1)), geo in _windows(*frame, grid):
        win = xt[:, r0:r1, c0:c1].contiguous()
        got = ff.conv1_pool1(win, kt, bt, list(geo))
        assert _close(got, ff.conv1_pool1_reference(win, kt, bt, list(geo)))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_k1_f32_at_an_offset_start(offset):
    """Images starting 4, 8 or 12 bytes past a 16-byte boundary (a view
    into a larger buffer) give the same result, bit for bit, as the same
    images at an aligned start."""
    _card()
    x, k, bias = _inputs(5, 2, 375, 1242)
    n = x.size
    buf = torch.zeros(n + 4, device="cuda")
    view = buf[offset:offset + n].view(x.shape)
    view.copy_(torch.from_numpy(x * 50))
    assert view.data_ptr() % 16 == 4 * offset
    kt, bt = torch.from_numpy(k).cuda(), torch.from_numpy(bias * 100).cuda()
    assert torch.equal(ff.conv1_pool1(view, kt, bt),
                       ff.conv1_pool1(view.clone(), kt, bt))


@pytest.mark.cuda
def test_cuda_k1_f32_takes_a_large_call_in_one_launch():
    """f32 images of 2^31 elements or more (B=1500 at 384x1248) take one
    launch, counted once; the images at either end come out bit for bit
    as in calls of their own."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    xt = torch.empty((1500, 384, 1248, 3), device="cuda")
    for chunk in xt.split(100):
        chunk.copy_(torch.randn(chunk.shape, device="cuda", generator=gen)
                    * 50)
    k = torch.randn((3, 3, 3, ff.FILTERS), device="cuda", generator=gen)
    bias = torch.randn(ff.FILTERS, device="cuda", generator=gen)
    before = ff.LAUNCHES, ff.F32_LAUNCHES
    got = ff.conv1_pool1(xt, k, bias)
    assert (ff.LAUNCHES - before[0], ff.F32_LAUNCHES - before[1]) == (1, 1)
    for lo, hi in ((0, 4), (1488, 1500)):
        assert torch.equal(got[lo:hi], ff.conv1_pool1(xt[lo:hi], k, bias))


@pytest.mark.cuda
def test_cuda_k1_f32_plan_is_the_kernels():
    """``fused_frontend.f32_plan`` equals the plan the kernel's launch
    computes (csrc/conv1_pool1.cu), at frames, batches and tile windows,
    on this card's SM count."""
    import ctypes

    from squeezedet_torch.ops import _cuda
    _card()
    fn = _cuda.function("conv1_pool1", "sdt_conv1_pool1_f32_plan",
                        [ctypes.c_int] * 4 + [ctypes.POINTER(
                            ctypes.c_int64)])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (1, 2, 8, 20, 128, 1500):
        for geo in [ff.geometry(h, w) for _, h, w in FRAMES] + TILE_GEOS:
            got = (ctypes.c_int64 * 5)()
            fn(b, geo[2], geo[3], sms, got)
            assert tuple(got) == tuple(ff.f32_plan(b, geo[2], geo[3], sms))
