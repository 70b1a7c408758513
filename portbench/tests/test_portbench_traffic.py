"""Traffic repeats exactly from its seed, and another seed gives the
same amount of work."""

import numpy as np
import pytest
import torch

from portbench import run, traffic
from portbench.reference import network

BIG = 2 ** 31 + 12345


def _mix(name):
    return run.load_json("portbench", "traffic", name + ".json")


def _cfg(name):
    return run.load_json("portbench", "configs", name + ".json")


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 62])
def test_frames_repeat_from_seed(seed):
    a = traffic.uint8_images(seed, "pool", (2, 8, 16, 3), "cpu")
    b = traffic.uint8_images(seed, "pool", (2, 8, 16, 3), "cpu")
    c = traffic.uint8_images(seed + 1, "pool", (2, 8, 16, 3), "cpu")
    assert a.dtype == torch.uint8 and torch.equal(a, b)
    assert not torch.equal(a, c)


def test_weights_repeat_from_seed():
    cfg = _cfg("squeezedet_kitti")
    shapes = network(cfg).param_shapes(cfg)
    a = traffic.he_weights(BIG, shapes, cfg["init"], "cpu")
    b = traffic.he_weights(BIG, shapes, cfg["init"], "cpu")
    c = traffic.he_weights(BIG + 1, shapes, cfg["init"], "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["conv12.weight"], c["conv12.weight"])
    assert sum(t.numel() for t in a.values()) == cfg["params"]
    # conv1 at 0.001 of He's deviation, the head at its own
    assert float(a["conv12.weight"].std()) == pytest.approx(0.1, rel=0.01)
    assert float(a["conv1.weight"].std()) == pytest.approx(
        0.001 * (2 / 27) ** 0.5, rel=0.2)


def test_train_feed_repeats_and_keeps_its_shapes():
    cfg, mix = _cfg("squeezedet_kitti"), _mix("train_recipe")
    a = traffic.train_feed(BIG, cfg, mix, 2)
    b = traffic.train_feed(BIG, cfg, mix, 2)
    c = traffic.train_feed(BIG + 1, cfg, mix, 2)
    k, bs, g = mix["steps_per_dispatch"], mix["batch"], mix["max_gt"]
    for x, y, z in zip(a, b, c):
        for key in x:
            assert np.array_equal(x[key], y[key])
            assert x[key].shape == z[key].shape
        assert x["pos"].shape == (k, bs) and x["gt_boxes"].shape == (
            k, bs, g, 4)
    rows = np.concatenate([d["pos"].ravel() for d in a])
    assert len(set(rows.tolist())) == len(rows)  # no row twice
    n = np.concatenate([d["num_gt"].ravel() for d in a])
    assert n.min() >= 1 and n.max() <= g
    boxes = np.concatenate([d["gt_boxes"][d["num_gt"][..., None] >
                                           np.arange(g)] for d in a])
    assert np.all(boxes[:, 2:] > 0)
    # drifts within the recipe's, boxes at the model's size
    aug = np.concatenate([d["aug"].reshape(-1, 5) for d in a])
    assert np.all(np.abs(aug[:, 0]) <= cfg["recipe"]["drift_x"])
    assert np.all(np.abs(aug[:, 1]) <= cfg["recipe"]["drift_y"])
    assert np.all(boxes[:, 0] - boxes[:, 2] / 2 > -cfg["image_width"] * 0.01)
    assert np.all(boxes[:, 0] + boxes[:, 2] / 2 < cfg["image_width"] * 1.01)
