"""The on-device resize serving path: ``resize_images`` and
``Detector.predict_raw_resize`` in the port against the JAX package's,
on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

import squeezedet_torch as st
from squeezedet_torch.data.device_pipeline import resize_images
from squeezedet_torch.weights import from_jax_params
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.data.device_pipeline import \
    resize_images as jax_resize_images
from squeezedet_tpu.models import get_model as jax_get_model

# Resized pixels to RESIZE_ATOL plus a sample-position term
# (resize_tolerance): the two packages weigh the same two taps in f32 in
# other orders (3.05e-5, 2 ulps at 255, measured on KITTI frames), and
# they round the sample positions (o + 0.5) * in / out - 0.5 in f32 in
# other orders, which moves a sample by up to an ulp or two of the
# input's extent and its value by that times the step to its neighbour
# (3.4e-4 measured at 11x37 -> 40x90 on values of std 50).
RESIZE_ATOL, POSITION_ULPS = 1e-4, 2
KITTI = (375, 1242)
# conv12 ~ N(0, 1): the scores spread out, as in test_torch_detector.py
HEAD_SCALE = 1.0


def resize_tolerance(x: np.ndarray) -> float:
    """RESIZE_ATOL plus POSITION_ULPS f32 spacings of the larger input
    extent times the largest step between neighbouring input pixels."""
    x = x.astype(np.float64)
    step = max(np.abs(np.diff(x, axis=1)).max(),
               np.abs(np.diff(x, axis=2)).max())
    extent = np.float32(max(x.shape[1], x.shape[2]))
    return RESIZE_ATOL + POSITION_ULPS * float(np.spacing(extent)) * step


@pytest.fixture(scope="module")
def frames():
    rs = np.random.RandomState(0)
    return rs.randint(0, 256, (2,) + KITTI + (3,)).astype(np.uint8)


@pytest.mark.parametrize("size", [(384, 1248), (96, 320), KITTI],
                         ids=["up", "down", "identity"])
def test_resize_matches_jax(frames, size):
    """KITTI frames to the model size (up), to the tiny test size (down,
    with no antialiasing in either package) and to their own size."""
    want = np.asarray(jax_resize_images(jnp.asarray(frames), *size))
    got = resize_images(torch.from_numpy(frames), *size)
    assert got.dtype == torch.float32 and got.shape == (2,) + size + (3,)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=resize_tolerance(frames))
    if size == KITTI:
        np.testing.assert_array_equal(got.numpy(), frames)


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (40, 90), (13, 300)])
def test_resize_float_edges_match_jax(size):
    """Float input with negative values, at sizes whose samples reach the
    edges, where JAX drops the taps outside the image and renormalises:
    odd ratios up and down on each axis, and one pixel."""
    x = np.random.RandomState(1).randn(3, 11, 37, 3).astype(np.float32) * 50
    want = np.asarray(jax_resize_images(jnp.asarray(x), *size))
    got = resize_images(torch.from_numpy(x), *size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=resize_tolerance(x))


@pytest.fixture(scope="module")
def pair():
    jdet = jax_get_model("squeezeDet", tiny_test_config())
    params, _, _ = jdet.init(jax.random.key(0))
    rs = np.random.RandomState(2)
    kernel = rs.randn(3, 3, 768, 72).astype(np.float32) * HEAD_SCALE
    params = dict(params, conv12={"kernel": jnp.asarray(kernel),
                                  "bias": params["conv12"]["bias"]})
    return params, from_jax_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_raw_resize_matches_jax(frames, pair, dtype):
    """375x1242 uint8 frames -> the tiny config's 96x96: every field of
    the Interpretation, f32 to 1e-5 (boxes 1e-4 px), as the port's other
    forward comparisons hold it (tests/test_torch_detector.py); bf16,
    which rounds at other places in the two frameworks, the raw preds to
    5e-2 of their largest magnitude (tests/test_torch_models.py)."""
    params, tree = pair
    jdet = jax_get_model("squeezeDet",
                         tiny_test_config().replace(compute_dtype=dtype))
    det = st.get_model("squeezeDet",
                       st.tiny_test_config().replace(compute_dtype=dtype),
                       device="cpu")
    det.backbone.load_state_dict(tree)
    want = jdet.predict_raw_resize(params, jnp.asarray(frames))
    got = det.predict_raw_resize(torch.from_numpy(frames))
    if dtype == "bfloat16":
        for name in ("pred_class_logits", "pred_conf", "pred_box_delta"):
            w = np.asarray(getattr(want, name))
            g = getattr(got, name).numpy()
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=5e-2 * np.abs(w).max(),
                                       err_msg=name)
        return
    for name in got._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape, name
        if name == "det_class":
            np.testing.assert_array_equal(g, w)
            continue
        atol = 1e-4 if name == "det_boxes" else 1e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_raw_resize_at_model_size_equals_predict_raw(pair, dtype):
    """Frames already at the model size: the resize is the identity, so
    the result equals ``predict_raw``'s bit for bit."""
    _, tree = pair
    det = st.get_model("squeezeDet",
                       st.tiny_test_config().replace(compute_dtype=dtype),
                       device="cpu")
    det.backbone.load_state_dict(tree)
    u8 = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (2, 96, 96, 3)).astype(np.uint8))
    got, want = det.predict_raw_resize(u8), det.predict_raw(u8)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_predict_raw_resize_on_the_cpu_runs_plain_k1(frames, pair):
    """The CPU path runs K1's plain version once a call (the wrapper
    counts a launch only on a CUDA tensor) and returns tensors on the
    images' device, outside autograd."""
    from squeezedet_torch.ops import fused_frontend as ff
    _, tree = pair
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu")
    det.backbone.load_state_dict(tree)
    before = ff.LAUNCHES
    out = det.predict_raw_resize(torch.from_numpy(frames))
    assert ff.LAUNCHES == before
    assert all(t.device.type == "cpu" and not t.requires_grad
               for t in out)
    assert out.det_boxes.shape == (2, det.anchors.shape[0], 4)
