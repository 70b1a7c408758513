"""K1 (conv1+pool1) in the port: the plain version against the JAX
package's Pallas kernel (interpret mode) and XLA path on the CPU; the
CUDA kernel against the plain version on a GPU.

The GPU cases run where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_fused_frontend.py``
so the JAX package is imported only inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from squeezedet_torch.ops import fused_frontend as ff
from torch_threads import one_thread  # noqa: F401  (autouse)


def _jax_xla_frontend(x, k, bias):
    """The JAX package's unfused conv1+pool1 (XLA)."""
    import jax.numpy as jnp

    from squeezedet_tpu.models import layers as L
    return np.asarray(L.max_pool(L.conv2d(
        {"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)},
        jnp.asarray(x), 2), 3, 2, "SAME"))


def _inputs(rng, b, h, w):
    x = rng.randn(b, h, w, 3).astype(np.float32)
    k = rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1
    bias = rng.randn(64).astype(np.float32) * 0.1
    return x, k, bias


def _port(x, k, bias):
    return ff.conv1_pool1(torch.from_numpy(x), torch.from_numpy(k),
                          torch.from_numpy(bias)).numpy()


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 96, 160),
                                   (1, 32, 1248)])
def test_plain_k1_matches_pallas_kernel(shape, rng):
    """Tolerance 1e-5: the two sum the 27 taps in different orders."""
    import jax.numpy as jnp

    from squeezedet_tpu.ops.fused_frontend import conv1_pool1_fused
    b, h, w = shape
    x, k, bias = _inputs(rng, b, h, w)
    want = np.asarray(conv1_pool1_fused(jnp.asarray(x), jnp.asarray(k),
                                        jnp.asarray(bias), interpret=True))
    launches = ff.LAUNCHES
    got = _port(x, k, bias)
    assert ff.LAUNCHES == launches  # a CPU tensor never launches
    assert got.shape == (b, h // 4, w // 4, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 33, 47), (2, 375, 1242),
                                   (1, 30, 62), (1, 9, 5)])
def test_plain_k1_matches_xla_at_any_size(shape, rng):
    """Odd and non-multiple-of-4 sizes (TF SAME pads (1, 1) on odd
    extents) against L.max_pool(L.conv2d(...)), to 1e-5."""
    b, h, w = shape
    x, k, bias = _inputs(rng, b, h, w)
    want = _jax_xla_frontend(x, k, bias)
    got = _port(x, k, bias)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_geometry_is_tf_same():
    # even extents pad (0, 1) in both layers; odd ones (1, 1)
    assert ff.geometry(384, 1248) == (192, 624, 96, 312, 0, 0, 0, 0)
    assert ff.geometry(375, 1242) == (188, 621, 94, 311, 1, 0, 0, 1)


def test_k1_corner_impulse_canary():
    """A corner impulse: TF SAME pads bottom/right on an even input, so
    the impulse reaches output (0, 0) through conv tap (0, 0) only;
    torch's symmetric padding=1 would route it through tap (1, 1)."""
    x = np.zeros((1, 8, 8, 3), np.float32)
    x[0, 0, 0, :] = 1.0
    k = np.zeros((3, 3, 3, 64), np.float32)
    k[0, 0, :, 0] = 1.0   # only tap (0, 0) of channel 0
    k[1, 1, :, 1] = 1.0   # only tap (1, 1) of channel 1
    got = _port(x, k, np.zeros(64, np.float32))
    want = _jax_xla_frontend(x, k, np.zeros(64, np.float32))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0, 0] == 3.0 and got[0, 0, 0, 1] == 0.0


def test_k1_bf16_rounds_once(rng):
    """bf16 images: f32 math on bf16-rounded operands, one final
    rounding, so the result is the f32 result rounded to bf16."""
    x, k, bias = _inputs(rng, 1, 16, 24)
    xb = torch.from_numpy(x).bfloat16()
    got = ff.conv1_pool1(xb, torch.from_numpy(k), torch.from_numpy(bias))
    want = ff.conv1_pool1(xb.float(), torch.from_numpy(k).bfloat16().float(),
                          torch.from_numpy(bias).bfloat16().float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["channels", "dtype", "kernel", "device"])
def test_k1_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 8, 8, 3)
    k, b = torch.zeros(3, 3, 3, 64), torch.zeros(64)
    if bad == "channels":
        x = torch.zeros(1, 8, 8, 4)
    elif bad == "dtype":
        x = x.half()
    elif bad == "kernel":
        k = torch.zeros(3, 3, 3, 32)
    else:
        x = x.to("meta")
    with pytest.raises((ValueError, TypeError)):
        ff.conv1_pool1(x, k, b)


@pytest.mark.parametrize("bad", ["offset", "strided"])
def test_k1_kernel_refuses_layouts_it_does_not_take(bad):
    """The CUDA kernel's own needs, checked before a launch: contiguous
    NHWC, and for the bf16 route a 16-byte aligned start (its loads are
    16 bytes wide); f32 takes any aligned-to-its-type start."""
    n = 8 * 8 * 3
    ff.check_kernel_layout(torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16))
    ff.check_kernel_layout(torch.zeros(n + 1)[1:].view(1, 8, 8, 3))
    if bad == "offset":
        x = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(1, 8, 8, 3)
    else:
        x = torch.zeros(1, 8, 16, 3, dtype=torch.bfloat16)[:, :, ::2]
    with pytest.raises(ValueError):
        ff.check_kernel_layout(x)


@pytest.mark.parametrize("wants", ["images", "kernel", "bias"])
def test_k1_refuses_a_gradient_it_would_drop(wants):
    """The CUDA kernel has no backward: a call that autograd would
    differentiate raises, naming the tensor, instead of returning a
    result with no graph.  Under no_grad, or with nothing requiring
    grad, the same call passes."""
    args = {"images": torch.zeros(1, 8, 8, 3),
            "kernel": torch.zeros(3, 3, 3, 64), "bias": torch.zeros(64)}
    args[wants].requires_grad_()
    with pytest.raises(RuntimeError, match=wants):
        ff.check_no_grad(args["images"], args["kernel"], args["bias"])
    with torch.no_grad():
        ff.check_no_grad(args["images"], args["kernel"], args["bias"])
    args[wants].requires_grad_(False)
    ff.check_no_grad(args["images"], args["kernel"], args["bias"])


def test_frozen_conv1_train_step_never_asks_k1_for_a_gradient(monkeypatch):
    """The train step (tiny config, CPU) runs K1's wrapper with grad mode
    on; every call passes the check the CUDA path makes, because conv1
    is frozen and the images need no gradient."""
    import squeezedet_torch as st
    from squeezedet_torch.optim import build_optimizer
    from squeezedet_torch.trainer import TrainState, make_train_step_device
    cfg = st.tiny_test_config().replace(keep_prob=1.0)
    det = st.get_model("squeezeDet", cfg, device="cpu")
    real, checked = ff.conv1_pool1, []

    def checking(images, kernel, bias):
        ff.check_no_grad(images, kernel, bias)
        checked.append(torch.is_grad_enabled())
        return real(images, kernel, bias)
    monkeypatch.setattr(ff, "conv1_pool1", checking)
    step = make_train_step_device(TrainState(det, build_optimizer(cfg, det)),
                                  uint8_ingest=True)
    u8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 96, 96, 3), dtype=np.uint8))
    boxes = torch.tensor([[[40.0, 40.0, 20.0, 30.0]]] * 2)
    lb = step(u8, boxes, torch.zeros(2, 1, dtype=torch.long),
              torch.tensor([1, 1]))
    assert checked == [True] and torch.isfinite(lb.total)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 384, 1248), (1, 375, 1242)])
def test_cuda_k1_matches_plain(shape, dtype):
    """CUDA kernel vs the plain version on the card, TF32 off: f32 to
    1e-4 + 1e-5*|x|; bf16 to 2 bf16 ulps (floored at the f32 bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    x, k, bias = _inputs(rng, *shape)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x * 50).to("cuda", dt)
    kt, bt = torch.from_numpy(k).cuda(), torch.from_numpy(bias * 100).cuda()
    launches = ff.LAUNCHES
    got = ff.conv1_pool1(xt, kt, bt).float()
    assert ff.LAUNCHES == launches + 1
    want = ff.conv1_pool1_reference(xt, kt, bt).float()
    allowed = 1e-4 + 1e-5 * want.abs()
    if dt == torch.bfloat16:
        _, e = torch.frexp(want.abs())
        ulp = torch.ldexp(torch.ones_like(want), e - 8) * (want != 0)
        allowed = torch.maximum(allowed, 2 * ulp)
    assert ((got - want).abs() <= allowed).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 375, 1242), (3, 33, 47), (1, 9, 5),
                                   (1, 2, 2), (1, 70, 131)])
def test_cuda_k1_bf16_tensor_cores_at_odd_sizes(shape):
    """The bf16 route at TF SAME geometries with odd extents, a tensor
    whose last 16-byte word is partial (1x9x5), a single-tile image and
    ragged tiles in both directions: within 2 bf16 ulps of the plain
    version (floored at 1e-4 + 1e-5*|x|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    x, k, bias = _inputs(np.random.RandomState(2), *shape)
    xt = torch.from_numpy(x * 50).to("cuda", torch.bfloat16)
    kt, bt = torch.from_numpy(k).cuda(), torch.from_numpy(bias * 100).cuda()
    got = ff.conv1_pool1(xt, kt, bt).float()
    want = ff.conv1_pool1_reference(xt, kt, bt).float()
    assert got.shape == want.shape
    _, e = torch.frexp(want.abs())
    ulp = torch.ldexp(torch.ones_like(want), e - 8) * (want != 0)
    allowed = torch.maximum(1e-4 + 1e-5 * want.abs(), 2 * ulp)
    assert ((got - want).abs() <= allowed).all()


@pytest.mark.cuda
@pytest.mark.parametrize("frame,grid", [((384, 1248), (2, 2)),
                                        ((375, 1242), (1, 1)),
                                        ((375, 1242), (3, 2))])
def test_cuda_k1_bf16_tma_at_frames_and_tile_windows(frame, grid):
    """The bf16 route's TMA boxes at a 1248-wide frame's tile windows, a
    1242-wide frame (rows of 7452 bytes, not a multiple of 16) and its
    tile windows: within 2 bf16 ulps of the plain version (floored at
    1e-4 + 1e-5*|x|), two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from squeezedet_torch.models import halo
    torch.backends.cudnn.allow_tf32 = False
    h, w = frame
    x, k, bias = _inputs(np.random.RandomState(4), 2, h, w)
    xt = torch.from_numpy(x * 50).to("cuda", torch.bfloat16)
    kt, bt = torch.from_numpy(k).cuda(), torch.from_numpy(bias * 100).cuda()
    hc, wc, hp, wp = ff.geometry(h, w)[:4]
    rows = halo.next_bounds(halo.next_bounds(
        halo.image_bounds(h, h // 16, grid[0]), 2, hc), 2, hp)
    cols = halo.next_bounds(halo.next_bounds(
        halo.image_bounds(w, w // 16, grid[1]), 2, wc), 2, wp)
    for rb in zip(rows, rows[1:]):
        for cb in zip(cols, cols[1:]):
            ((r0, r1), (c0, c1)), geo = ff.tile_geometry(h, w, rb, cb)
            win = xt[:, r0:r1, c0:c1].contiguous()
            got = ff.conv1_pool1(win, kt, bt, list(geo))
            assert torch.equal(got, ff.conv1_pool1(win, kt, bt, list(geo)))
            want = ff.conv1_pool1_reference(win, kt, bt, list(geo)).float()
            _, e = torch.frexp(want.abs())
            ulp = torch.ldexp(torch.ones_like(want), e - 8) * (want != 0)
            allowed = torch.maximum(1e-4 + 1e-5 * want.abs(), 2 * ulp)
            assert ((got.float() - want).abs() <= allowed).all()


@pytest.mark.cuda
def test_cuda_k1_bf16_counts_each_launch_of_a_cut_call():
    """bf16 images of 2^31 elements or more (B=1500 at 384x1248: 2.157e9)
    are cut into two launches, both counted in LAUNCHES; the images on
    either side of the cut come out bit for bit as in calls of their
    own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(5)
    xt = torch.empty((1500, 384, 1248, 3), dtype=torch.bfloat16,
                     device="cuda")
    for chunk in xt.split(100):
        chunk.copy_(torch.randn(chunk.shape, device="cuda", generator=gen)
                    * 50)
    k = torch.randn((3, 3, 3, ff.FILTERS), device="cuda", generator=gen)
    bias = torch.randn(ff.FILTERS, device="cuda", generator=gen)
    launches = ff.LAUNCHES
    got = ff.conv1_pool1(xt, k, bias)
    assert ff.LAUNCHES == launches + 2
    for lo, hi in ((0, 4), (1488, 1500)):
        assert torch.equal(got[lo:hi], ff.conv1_pool1(xt[lo:hi], k, bias))
