"""The port's copy of the class-correlated KITTI fixture
(``squeezedet_torch.data.synth.make_synth_kitti``, written with the
port's PNG codec) against ``tests/synth_kitti.py`` (OpenCV): the same
pixels, label files and image set for a seed."""

import os

import cv2
import pytest

from squeezedet_torch.data.synth import make_synth_kitti
from synth_kitti import make_synth_kitti as reference


@pytest.mark.parametrize("kw", [
    dict(num_images=5, width=320, height=96, seed=3, image_set="train"),
    dict(num_images=2, width=1248, height=384, seed=7, image_set="val",
         start_index=1000)], ids=["small", "recipe_val"])
def test_fixture_equals_the_tests_generator(kw, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert make_synth_kitti(port, **kw) == reference(ref, **kw)
    with open(os.path.join(port, "ImageSets", kw["image_set"] + ".txt")) as f:
        indices = f.read().split()
    with open(os.path.join(ref, "ImageSets", kw["image_set"] + ".txt")) as f:
        assert f.read().split() == indices
    assert len(indices) == kw["num_images"]
    for idx in indices:
        a, b = (cv2.imread(os.path.join(r, "training", "image_2",
                                        idx + ".png")) for r in (port, ref))
        assert a.shape == (kw["height"], kw["width"], 3)
        assert (a == b).all(), idx
        labels = []
        for r in (port, ref):
            with open(os.path.join(r, "training", "label_2",
                                   idx + ".txt")) as f:
                labels.append(f.read())
        assert labels[0] == labels[1], idx
