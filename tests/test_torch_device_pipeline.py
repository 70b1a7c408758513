"""The port's on-device ingest against the JAX package on the CPU: the
greedy anchor matcher and the augment + resize + normalize program."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from squeezedet_torch.data import device_pipeline as TP
from squeezedet_torch.ops.boxes import batch_iou
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.data import device_pipeline as JP
from squeezedet_tpu.ops.boxes import batch_iou as jax_batch_iou


def _assign_both(anchors, boxes, labels, num_gt, num_classes):
    want = JP.assign_anchors_device(jnp.asarray(anchors), jnp.asarray(boxes),
                                    jnp.asarray(labels), jnp.asarray(num_gt),
                                    num_classes)
    got = TP.assign_anchors_device(torch.from_numpy(anchors),
                                   torch.from_numpy(boxes),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(num_gt), num_classes)
    return got, want


def _check_equal(got, want):
    """Mask, labels and boxes exact; deltas to 1e-6 (log and divide)."""
    for name in ("input_mask", "labels", "box_input"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.box_delta_input.numpy(),
                               np.asarray(want.box_delta_input), rtol=1e-6,
                               atol=1e-6)


def test_batch_iou_matches_jax(rng):
    anchors = np.asarray(tiny_test_config().anchor_box, np.float32)
    box = np.array([40.0, 50.0, 30.0, 20.0], np.float32)
    want = np.asarray(jax_batch_iou(jnp.asarray(anchors), jnp.asarray(box)))
    got = batch_iou(torch.from_numpy(anchors), torch.from_numpy(box))
    np.testing.assert_array_equal(got.numpy(), want)
    two = torch.from_numpy(np.stack([box, box * 1.1]))
    rows = batch_iou(torch.from_numpy(anchors), two)
    assert rows.shape == (2, len(anchors))
    np.testing.assert_array_equal(rows[0].numpy(), want)


def test_matcher_matches_jax_on_random_gt(rng):
    """Tiny-config anchors, 3 images with 5, 0 and 2 of 6 slots valid;
    the padded slots hold boxes that would claim anchors if read."""
    cfg = tiny_test_config()
    anchors = np.asarray(cfg.anchor_box, np.float32)
    b, g = 3, 6
    boxes = np.stack([rng.uniform(5, 90, (b, g)), rng.uniform(5, 90, (b, g)),
                      rng.uniform(6, 40, (b, g)), rng.uniform(6, 40, (b, g))],
                     axis=-1).astype(np.float32)
    labels = rng.randint(0, cfg.classes, (b, g)).astype(np.int32)
    num_gt = np.array([5, 0, 2], np.int32)
    got, want = _assign_both(anchors, boxes, labels, num_gt, cfg.classes)
    _check_equal(got, want)
    assert got.input_mask.sum(1).tolist() == [5.0, 0.0, 2.0]


def test_matcher_ties_follow_jax():
    """IoU ties go to the largest anchor index, distance-fallback ties to
    the smallest; a repeated GT box takes the next unclaimed anchor."""
    a = np.array([[10, 10, 8, 8], [50, 10, 8, 8], [10, 10, 8, 8],
                  [30, 10, 8, 8], [50, 10, 8, 8]], np.float32)
    boxes = np.array([[
        [10, 10, 8, 8],     # IoU 1 with anchors 0 and 2 -> 2
        [10, 10, 8, 8],     # again: 2 is claimed -> 0
        [40, 90, 8, 8],     # no overlap; equidistant to anchors 1, 3
                            # and 4: distance tie -> 1
        [40, 90, 8, 8],     # again: 3 and 4 tie -> 3
        [0, 0, 1, 1],       # padded slot: ignored
    ]], np.float32)
    labels = np.array([[0, 1, 2, 0, 1]], np.int32)
    num_gt = np.array([4], np.int32)
    got, want = _assign_both(a, boxes, labels, num_gt, 3)
    _check_equal(got, want)
    np.testing.assert_array_equal(got.input_mask.numpy(), [[1, 1, 1, 1, 0]])
    # each anchor carries the label of the slot that claimed it
    assert got.labels[0].argmax(1).tolist() == [1, 2, 0, 0, 0]
    assert got.labels[0, 4].sum() == 0


@pytest.mark.parametrize("aug", [
    [[0, 0, 0, 64, 36], [5, 3, 1, 60, 30], [-7, -4, 0, 69, 38]],
    [[-3, 2, 1, 50, 20], [8, -2, 1, 62, 40], [0, 0, 1, 70, 40]],
], ids=["mixed", "flipped"])
def test_augment_resize_normalize_matches_jax(rng, aug):
    """Drift (positive and negative), flip, resize and the pad-to-zero
    rules, to atol 2e-3 on values up to ~150 (f32 contractions in other
    orders); garbage beyond each image's extent never leaks."""
    canvas = rng.randint(0, 256, (3, 40, 70, 3)).astype(np.uint8)
    aug = np.asarray(aug, np.float32)
    means = tiny_test_config().bgr_means
    want = np.asarray(JP.augment_resize_normalize(
        jnp.asarray(canvas), jnp.asarray(aug), 24, 48, means))
    got = TP.augment_resize_normalize(torch.from_numpy(canvas),
                                      torch.from_numpy(aug), 24, 48, means)
    assert got.shape == (3, 24, 48, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    # bfloat16 output is the f32 result rounded once
    got16 = TP.augment_resize_normalize(torch.from_numpy(canvas),
                                        torch.from_numpy(aug), 24, 48, means,
                                        torch.bfloat16)
    torch.testing.assert_close(got16, got.bfloat16(), rtol=0, atol=0)
