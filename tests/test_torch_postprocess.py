"""On-device postprocess of the port against the JAX package's
``filter_prediction_device`` (exact: same ranks, same keep mask)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from squeezedet_torch.ops import postprocess as tp
from squeezedet_tpu.ops import postprocess as jp
from squeezedet_tpu.ops.nms import filter_prediction_np


def _both(boxes, probs, cls, **kw):
    want = jp.filter_prediction_device(
        jnp.asarray(boxes), jnp.asarray(probs), jnp.asarray(cls), **kw)
    got = tp.filter_prediction_device(
        torch.from_numpy(boxes), torch.from_numpy(probs),
        torch.from_numpy(cls), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_same(want, got):
    wb, wp, wc, wk = want
    gb, gp, gc, gk = got
    assert gb.shape == wb.shape and gk.dtype == np.bool_
    np.testing.assert_allclose(gb, wb, rtol=0, atol=0)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gk, wk)


@pytest.mark.parametrize("top_n,num", [(16, 200), (64, 40), (8, 8)])
def test_filter_matches_jax(rng, top_n, num):
    """Random overlapping boxes over 3 classes; includes the regime where
    prob_thresh applies (top_n >= anchors)."""
    b = 3
    boxes = np.stack([rng.uniform(50, 400, (b, num)),
                      rng.uniform(50, 200, (b, num)),
                      rng.uniform(20, 150, (b, num)),
                      rng.uniform(20, 150, (b, num))], -1).astype(np.float32)
    probs = rng.uniform(0, 1, (b, num)).astype(np.float32)
    probs[:, :3] = 0.001  # below prob_thresh
    cls = rng.randint(0, 3, (b, num)).astype(np.int32)
    want, got = _both(boxes, probs, cls, top_n=top_n, nms_thresh=0.4,
                      num_classes=3, prob_thresh=0.005)
    assert got[0].shape == (b, min(top_n, num), 4)
    _assert_same(want, got)


def test_all_tied_scores_rank_larger_anchor_first():
    """The all-tied case of tests/test_postprocess.py: equal scores rank
    the larger anchor index first, and the host oracle agrees."""
    n = 40
    rng = np.random.RandomState(3)
    boxes = np.stack([rng.uniform(50, 950, n), rng.uniform(50, 250, n),
                      np.full(n, 300.0), np.full(n, 300.0)],
                     axis=1).astype(np.float32)
    probs = np.full((n,), 0.75, np.float32)
    cls = np.zeros((n,), np.int32)
    want, got = _both(boxes[None], probs[None], cls[None], top_n=16,
                      nms_thresh=0.4, num_classes=3)
    _assert_same(want, got)
    lists = tp.device_results_to_lists(*(g[0] for g in got), num_classes=3)
    host = filter_prediction_np(boxes, probs, cls.astype(np.int64),
                                classes=3, top_n_detection=16,
                                prob_thresh=0.005, nms_thresh=0.4)
    assert len(lists[0]) == len(host[0])
    np.testing.assert_allclose(np.asarray(lists[0]), np.asarray(host[0]),
                               rtol=1e-6)


def test_tied_scores_prob_thresh_regime():
    """Tied pairs when top_n >= anchors: one survivor per pair."""
    boxes = np.array([[100.0, 100.0, 50.0, 50.0],
                      [105.0, 102.0, 50.0, 50.0],
                      [600.0, 100.0, 50.0, 50.0],
                      [604.0, 103.0, 50.0, 50.0]], np.float32)
    probs = np.full((4,), 0.5, np.float32)
    cls = np.zeros((4,), np.int32)
    want, got = _both(boxes[None], probs[None], cls[None], top_n=64,
                      nms_thresh=0.4, num_classes=3)
    _assert_same(want, got)
    assert got[3].sum() == 2


def test_device_results_to_lists_matches_jax(rng):
    boxes = rng.uniform(0, 100, (10, 4)).astype(np.float32)
    probs = rng.uniform(0, 1, 10).astype(np.float32)
    classes = rng.randint(0, 3, 10)
    keep = rng.rand(10) > 0.3
    for thresh in (None, 0.5):
        got = tp.device_results_to_lists(boxes, probs, classes, keep, 3,
                                         plot_prob_thresh=thresh)
        want = jp.device_results_to_lists(boxes, probs, classes, keep, 3,
                                          plot_prob_thresh=thresh)
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      np.asarray(want[0]))
        assert got[1:] == want[1:]
