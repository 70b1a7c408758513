"""K2 (filter gradient) in the port: the plain version against the JAX
package's Pallas kernel (interpret mode) and torch's own conv weight
gradient on the CPU, the routing through ``layers.conv2d`` and
``conv2d_pair``, and the CUDA kernel against the plain version on a GPU.

The GPU case runs where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_filter_grad.py``
so the JAX package is imported only inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from squeezedet_torch.models import layers as TL
from squeezedet_torch.ops import filter_grad as fg

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
    for positions, tiles in [(149760, 2), (37440, 108), (1, 1), (33, 1000),
                             (40000, 1)]:
        splits, chunk = fg.split_k(positions, tiles)
        assert chunk % 32 == 0 and 1 <= splits <= 65535
        assert splits * chunk >= positions > (splits - 1) * chunk


# (B, kh, kw, H, W, C, O): the train step's routed convs at B=20 and 128,
# the odd shapes, and a C and an O that leave ragged tiles
PLAN_SHAPES = [(20, 1, 1, 48, 156, 128, 32), (128, 1, 1, 48, 156, 128, 32),
               (20, 3, 3, 24, 78, 384, 72), (128, 3, 3, 24, 78, 384, 72),
               (128, 1, 1, 24, 78, 384, 96), (2, 5, 5, 9, 11, 128, 128),
               (1, 1, 1, 1, 1, 8, 8), (2, 3, 3, 5, 7, 200, 136)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_position_tap_and_tile(shape, dtype):
    """The launch plan: its grid covers every (C tile, O tile) of every
    tap once, and its splits cover every position once, in whole steps of
    32, within the grid's 65535 limit."""
    b, kh, kw, h, w, c, o = shape
    route = fg.ROUTES[getattr(torch, dtype)]
    p = fg.plan(b, h, w, c, o, kh, kw, getattr(torch, dtype))
    tiles_c, tiles_o = -(-c // route.tile_c), -(-o // route.tile_o)
    assert tiles_c * route.tile_c >= c > (tiles_c - 1) * route.tile_c
    assert tiles_o * route.tile_o >= o > (tiles_o - 1) * route.tile_o
    assert p.tiles == tiles_c * tiles_o * kh * kw
    positions = b * h * w
    assert p.chunk % 32 == 0 and 1 <= p.splits <= 65535
    assert p.splits * p.chunk >= positions > (p.splits - 1) * p.chunk
    if p.splits > 1:  # split only while blocks are short of the target
        assert p.tiles * (p.splits - 1) < route.target_blocks
        if route.one_wave:  # and never past one wave
            assert p.tiles * p.splits <= route.target_blocks


def test_bf16_plan_bounds_the_workspace():
    """At B=128 the bf16 route's split-K workspace traffic (f32 partials
    written once and read back once) stays under 20 % of the operands'
    bytes at the train shapes: 2.8 % at the fire5 squeeze (958k
    positions, 264 splits), 8 % at conv12's 3x3 (27 tiles, 9 splits)."""
    for b, kh, kw, h, w, c, o in [PLAN_SHAPES[i] for i in (1, 3, 4)]:
        p = fg.plan(b, h, w, c, o, kh, kw, torch.bfloat16)
        ws = 2 * 4 * p.splits * kh * kw * c * o
        assert ws < 0.2 * 2 * b * h * w * (c + o), (b, kh, c, o, ws)


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
