"""The port's Pascal VOC layer against the JAX package's on the CPU, on
the synthetic VOC fixture of ``tests/synth_voc.py``: annotations, the
scorer (``voc_eval``) and ``PascalVoc.evaluate_detections`` give equal
records, curves and APs; the CLIs' config and dataset dispatch return
VOC; and the port's train and eval CLIs run on it."""

import os

import numpy as np
import pytest

from squeezedet_torch.config import config_for_dataset
from squeezedet_torch.data import imdb_for_dataset
from squeezedet_torch.data import voc_eval
from squeezedet_torch.data.pascal_voc import PascalVoc
from squeezedet_tpu.config.voc import \
    config_for_dataset as jax_config_for_dataset
from squeezedet_tpu.data import PascalVoc as JaxPascalVoc
from squeezedet_tpu.data import voc_eval as jax_voc_eval
from synth_voc import CLASSES, make_synth_voc

W, H = 160, 96


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    make_synth_voc(root, num_images=8, width=320, height=192,
                   image_set="test", seed=2)
    return root


def _cfgs():
    kw = dict(class_names=CLASSES, batch_size=2)
    return (config_for_dataset("VOC", "squeezeDet", W, H).replace(**kw),
            jax_config_for_dataset("VOC", "squeezeDet", W, H).replace(**kw))


def _all_boxes(db, seed=0):
    """GT boxes jittered, a few dropped, one background box per image."""
    rng = np.random.RandomState(seed)
    boxes = [[[] for _ in db.image_idx] for _ in CLASSES]
    for i, idx in enumerate(db.image_idx):
        for cx, cy, w, h, cls in db._rois[idx]:
            if rng.rand() < 0.2:
                continue
            j = rng.randn(4) * 3.0
            boxes[int(cls)][i].append(
                [cx - w / 2 + j[0], cy - h / 2 + j[1], cx + w / 2 + j[2],
                 cy + h / 2 + j[3], float(rng.uniform(0.05, 0.99))])
        boxes[rng.randint(3)][i].append([5.0, 5.0, 60.0, 50.0,
                                         float(rng.rand())])
    return boxes


def test_config_matches_jax():
    port, jax_cfg = (config_for_dataset("VOC", "squeezeDet", W, H),
                     jax_config_for_dataset("VOC", "squeezeDet", W, H))
    assert port.dataset == jax_cfg.dataset == "PASCAL_VOC"
    assert port.class_names == jax_cfg.class_names and port.classes == 20
    assert (port.image_width, port.image_height, port.anchors) == \
        (jax_cfg.image_width, jax_cfg.image_height, jax_cfg.anchors)
    np.testing.assert_array_equal(port.anchor_box, jax_cfg.anchor_box)
    with pytest.raises(ValueError, match="KITTI or VOC"):
        config_for_dataset("COCO", "squeezeDet")


def test_annotations_match_jax(voc_root):
    cfg, jcfg = _cfgs()
    port = imdb_for_dataset("VOC", "test", voc_root, cfg)
    jax_db = JaxPascalVoc("test", "2007", voc_root, jcfg)
    assert isinstance(port, PascalVoc) and port.year == "2007"
    assert port.image_idx == jax_db.image_idx and len(port.image_idx) == 8
    assert port._rois == jax_db._rois
    xml = os.path.join(voc_root, "VOC2007", "Annotations", "000003.xml")
    assert voc_eval.parse_rec(xml) == jax_voc_eval.parse_rec(xml)
    # the canvas readers size JPEGs by their header (PIL)
    assert port.canvas_size() == jax_db.canvas_size() == (192, 320)


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_eval_matches_jax(voc_root, tmp_path, use_07):
    cfg, _ = _cfgs()
    db = PascalVoc("test", "2007", voc_root, cfg)
    template = db._write_class_det_files(str(tmp_path / "dets"),
                                         _all_boxes(db))
    base = os.path.join(voc_root, "VOC2007")
    for cls in CLASSES:
        args = (template, os.path.join(base, "Annotations", "{:s}.xml"),
                os.path.join(base, "ImageSets", "Main", "test.txt"), cls)
        got = voc_eval.voc_eval(*args, str(tmp_path / "port_cache"),
                                use_07_metric=use_07)
        want = jax_voc_eval.voc_eval(*args, str(tmp_path / "jax_cache"),
                                     use_07_metric=use_07)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert 0 < got[2] < 1, cls


def test_evaluate_detections_matches_jax(voc_root, tmp_path):
    cfg, jcfg = _cfgs()
    port = PascalVoc("test", "2007", voc_root, cfg)
    jax_db = JaxPascalVoc("test", "2007", voc_root, jcfg)
    boxes = _all_boxes(port, seed=1)
    aps, names = port.evaluate_detections(str(tmp_path / "port"), 3, boxes)
    want, want_names = jax_db.evaluate_detections(str(tmp_path / "jax"), 3,
                                                  boxes)
    assert names == want_names == list(CLASSES)
    assert aps == want
    for cls in CLASSES:
        rel = os.path.join("detection_files_3", cls + ".txt")
        with open(str(tmp_path / "port" / rel)) as f:
            port_dets = f.read()
        with open(str(tmp_path / "jax" / rel)) as f:
            assert port_dets == f.read()


def test_voc_train_and_eval_clis(tmp_path, capsys):
    """``--dataset VOC`` through the port's train and eval CLIs: two
    steps, then one scored poll."""
    from squeezedet_torch import eval as eval_cli
    from squeezedet_torch import train as train_cli
    root = str(tmp_path / "voc")
    make_synth_voc(root, num_images=4, width=W, height=H, image_set="train",
                   seed=3)
    common = ["--device", "cpu", "--dataset", "VOC", "--data_path", root,
              "--image_set", "train", "--image_width", str(W),
              "--image_height", str(H)]
    state = train_cli.main(common + [
        "--train_dir", str(tmp_path / "tr"), "--batch_size", "2",
        "--max_steps", "2", "--checkpoint_step", "1", "--summary_step", "0",
        "--device_assign", "--uint8_ingest", "--device_augment"])
    assert state.det.cfg.classes == 20 and state.step == 2
    eval_cli.main(common + ["--checkpoint_path", str(tmp_path / "tr"),
                            "--eval_dir", str(tmp_path / "ev"),
                            "--run_once", "--eval_batch_size", "2"])
    out = capsys.readouterr().out
    assert "Mean average precision:" in out and "Mean AP = " in out
