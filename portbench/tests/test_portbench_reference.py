"""The plain reference against the program at a tiny size on the CPU,
with the program computing in float32, where the two must agree to
float32's rounding."""

import importlib

import pytest
import torch

from portbench.runners.score import reference_detections
from portbench.reference import compare, detect
from portbench.tests import tiny


def _runner(name, mix, seed, cfg=None):
    """The runner of cell ``name`` at the tiny size (``cfg`` in place of
    its configuration), the program in float32."""
    c = tiny.cell(name, **mix)
    if cfg is not None:
        c["cfg"] = cfg
    c["cfg"]["compute_dtype"] = "float32"
    return importlib.import_module(
        "portbench.runners." + c["mix"]["runner"]).Runner(
            c["cfg"], c["mix"], seed, "cpu")


@pytest.mark.parametrize("name", ["sqdet.score.b128",
                                  "sqdetplus.score.b128"])
def test_scoring_path(name):
    scores_as_the_reference(_runner(name, tiny.SCORE, 11))


def scores_as_the_reference(d):
    """The score runner ``d``'s window agrees with the reference."""
    d.setup()
    d.window(0.05)
    d.release()
    outs, frames = d.judged()
    ref = reference_detections(d.cfg, d.weights, frames, 4)
    mine = detect.filter_top(d.cfg, ref)
    assert torch.allclose(outs[0], mine[0], atol=1e-3, rtol=1e-5)
    assert torch.allclose(outs[1], mine[1], atol=1e-6, rtol=1e-5)
    assert torch.equal(outs[2].long(), mine[2].long())
    assert torch.equal(outs[3].bool(), mine[3].bool())
    numbers, _ = compare.detection_gaps(d.cfg, outs, ref,
                                        detect.anchors(d.cfg, "cpu"))
    assert numbers["head_gap"] < 1e-5
    # bfloat16's own gaps are thousands of times float32's
    assert d.check()["head_gap_x_bf16"] < 1e-2
    assert numbers["nms_flips"] == 0


# two steps: a max-pool's or a ReLU's choice that flips on float32's
# rounding in a later step parts the two trajectories
TRAIN_1 = dict(tiny.TRAIN, steps_per_dispatch=1)


@pytest.mark.parametrize("seed", [12, 13])
def test_training_path(seed):
    trains_as_the_reference(_runner("sqdet.train.b20k8", TRAIN_1, seed))


def trains_as_the_reference(d):
    """The train runner ``d``'s set-up and window agree with the
    reference."""
    d.setup()
    d.window(0.05)
    d.release()
    numbers = d.check()
    assert numbers["grad_angle"] < 1e-8 and numbers["head_grad_angle"] < 1e-8
    assert numbers["step_gap"] < 1e-4
    assert d.detail["first_masks_read"] and d.detail["masks_redrawn_equal"]
    # the window's last dispatch, followed from the program's state
    assert numbers["window_loss_gap"] < 1e-5
    assert numbers["window_step_gap"] < 1e-4
    assert d.detail["window_angle"] < 1e-6
    assert max(d.detail["step_loss_gaps"]) < 1e-4
    assert d.detail["grad_gap"] < 1e-4
    # the worst leaf carries the second step's flips
    assert d.detail["worst_momentum_gap"] < 1e-2


def test_augment_and_assignment_equal_the_program():
    from squeezedet_torch.data.device_pipeline import (
        assign_anchors_device, augment_resize_normalize)
    from portbench.reference import train
    d = _runner("sqdet.train.b20k8", tiny.TRAIN, 14)
    d.setup()
    d.release()
    cfg = d.cfg
    anchors = detect.anchors(cfg, "cpu")
    for feed in d.feed:
        for s in range(feed["pos"].shape[0]):
            canvas = d.dataset[feed["pos"][s].long()]
            got = augment_resize_normalize(
                canvas, feed["aug"][s], cfg["image_height"],
                cfg["image_width"], cfg["bgr_means"])
            assert torch.allclose(got, train.augment(cfg, canvas,
                                                     feed["aug"][s]),
                                  atol=1e-3)
            t = assign_anchors_device(anchors, feed["gt_boxes"][s],
                                      feed["gt_labels"][s],
                                      feed["num_gt"][s], cfg["classes"])
            mask, deltas, boxes, labels = train.assign(
                cfg, anchors, feed["gt_boxes"][s], feed["gt_labels"][s],
                feed["num_gt"][s])
            assert torch.equal(t.input_mask, mask)
            assert torch.allclose(t.box_delta_input, deltas, atol=1e-6)
            assert torch.equal(t.box_input, boxes)
            assert torch.equal(t.labels, labels)
