"""The slice end to end: uint8 -> (boxes, probs, classes, keep) in the
port against the JAX package at the tiny config, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch.ops.boxes import pairwise_iou_center
from squeezedet_torch.weights import from_jax_params
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.models import get_model as jax_get_model

# conv12 drawn as N(0, 1) * HEAD_SCALE: the 1e-4 init leaves every score
# near 1/6 (all ties); at this scale the top-64 scores spread out and NMS
# suppresses some candidates
HEAD_SCALE = 1.0


@pytest.fixture(scope="module")
def pair():
    jdet = jax_get_model("squeezeDet", tiny_test_config())
    params, _, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    kernel = rng.randn(3, 3, 768, 72).astype(np.float32) * HEAD_SCALE
    params = dict(params, conv12={"kernel": jnp.asarray(kernel),
                                  "bias": params["conv12"]["bias"]})
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu")
    det.backbone.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params)))
    return jdet, params, det, u8


def test_uint8_to_detections_matches_jax(pair):
    """Order, classes and keep equal; boxes to 1e-4 px; probs to 1e-6.
    Precondition, asserted: the reference's top-65 scores are separated
    by more than twice the largest score difference between the two
    packages, and its same-class IoUs sit 1e-4 or more from nms_thresh."""
    jdet, params, det, u8 = pair
    jinterp = jdet.predict_raw(params, jnp.asarray(u8))
    tinterp = det.predict_raw(torch.from_numpy(u8))
    jprobs = np.asarray(jinterp.det_probs)
    noise = np.abs(jprobs - tinterp.det_probs.numpy()).max()
    top = -np.sort(-jprobs, axis=1)[:, :65]
    assert (top[:, :-1] - top[:, 1:]).min() > 2 * noise

    want = [np.asarray(o) for o in
            jdet.predict_raw_postprocessed(params, jnp.asarray(u8))]
    got = [o.numpy() for o in
           det.predict_raw_postprocessed(torch.from_numpy(u8))]
    top_boxes = torch.tensor(want[0])
    iou = pairwise_iou_center(top_boxes, top_boxes).numpy()
    same = (want[2][:, :, None] == want[2][:, None, :]) & ~np.eye(64, dtype=bool)
    assert np.abs(iou - 0.4)[same].min() > 1e-4
    assert 0 < want[3].sum() < want[3].size  # NMS suppressed some

    assert [g.shape for g in got] == [w.shape for w in want] == \
        [(2, 64, 4), (2, 64), (2, 64), (2, 64)]
    assert got[2].dtype == want[2].dtype == np.int32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_interpretation_matches_jax(pair):
    """Every field of the decoded output, to 1e-5 (boxes 1e-4 px)."""
    jdet, params, det, u8 = pair
    want = jdet.predict_raw(params, jnp.asarray(u8))
    got = det.predict_raw(torch.from_numpy(u8))
    for name in got._fields:
        if name == "det_class":
            continue  # exact class equality is checked through the ranks
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape, name
        atol = 1e-4 if name == "det_boxes" else 1e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def test_predict_postprocessed_equals_raw_path(pair):
    """predict_postprocessed on the mean-subtracted f32 images equals the
    uint8 path (the normalisation is the only difference)."""
    _, _, det, u8 = pair
    x = u8.astype(np.float32) - det.cfg.bgr_means_array()
    a = det.predict_postprocessed(torch.from_numpy(x))
    b = det.predict_raw_postprocessed(torch.from_numpy(u8))
    for ga, gb in zip(a, b):
        assert torch.equal(ga, gb)
