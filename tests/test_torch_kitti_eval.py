"""The port's KITTI scoring against the JAX package's on the CPU.

* ``kitti_ap.evaluate`` of both packages writes byte-equal output trees
  on the three fixtures of ``tests/test_oracle_eval.py`` (score ties at
  recall sample points, empty det files, a never-detected class,
  DontCare-saturated images, Van/Person_sitting ignores).
* The port's copy of the C++ evaluator, built by ``native`` with this
  host's g++, writes the same stats files as the port's Python scorer:
  APs to rtol 1e-5 and the 11-point and plot rows to 1e-6, as
  ``tests/test_native_eval.py`` holds the JAX package's pair.
* ``Kitti``'s det-file writer, scoring, error analysis and its gallery
  give the JAX ``Kitti``'s files, APs and stats for the same
  ``all_boxes``.
"""

import filecmp
import os
import random
import shutil

import numpy as np
import pytest

import squeezedet_torch as st
from squeezedet_torch import native
from squeezedet_torch.data import kitti_ap
from squeezedet_torch.data.kitti import NATIVE, PYTHON, Kitti
from squeezedet_tpu.config import tiny_test_config as jax_tiny_config
from squeezedet_tpu.data import Kitti as JaxKitti
from squeezedet_tpu.data import kitti_ap as jax_kitti_ap
from synth_kitti import make_synth_kitti
from test_oracle_eval import CASES, _compare_trees

AP_RTOL, ROW_ATOL = 1e-5, 1e-6


def _tree(root):
    """Relative path -> bytes of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _case(case, tmp_path):
    root, n = CASES[case](str(tmp_path / "fixture"))
    return (root, n, os.path.join(root, "ImageSets", "val.txt"),
            os.path.join(root, "training", "label_2"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_scorer_matches_jax_byte_for_byte(case, tmp_path):
    root, n, image_set, gt_dir = _case(case, tmp_path)
    res = {}
    for name, evaluate in (("jax", jax_kitti_ap.evaluate),
                           ("port", kitti_ap.evaluate)):
        res[name] = str(tmp_path / name)
        shutil.copytree(os.path.join(root, "results"), res[name])
        got = evaluate(res[name], image_set, gt_dir, n)
        res[name + "_aps"] = got
    assert res["port_aps"] == res["jax_aps"]
    want, got = _tree(res["jax"]), _tree(res["port"])
    assert sorted(got) == sorted(want)
    assert any(p.startswith("stats_") for p in want)
    for rel in want:
        assert got[rel] == want[rel], rel


@pytest.fixture(scope="module")
def binary():
    return native.build_kitti_eval()


def _noisy_fixture(root):
    """Synthetic KITTI + noisy detections with varied scores, FPs and
    misses, a DontCare region and a Van (tests/test_native_eval.py's)."""
    make_synth_kitti(root, num_images=40, width=320, height=96,
                     image_set="val")
    rng = np.random.RandomState(7)
    lbl_dir = os.path.join(root, "training", "label_2")
    with open(os.path.join(lbl_dir, "000000.txt"), "a") as f:
        f.write("DontCare -1 -1 -10 5.00 5.00 60.00 60.00 "
                "-1 -1 -1 -1000 -1000 -1000 -10\n")
        f.write("Van 0.00 0 0.0 250.00 10.00 315.00 90.00 "
                "1.5 1.6 3.7 0.0 1.7 10.0 0.0\n")
    data_dir = os.path.join(root, "results", "data")
    os.makedirs(data_dir)
    with open(os.path.join(root, "ImageSets", "val.txt")) as f:
        indices = [x.strip() for x in f if x.strip()]
    for idx in indices:
        lines = []
        with open(os.path.join(lbl_dir, idx + ".txt")) as f:
            for line in f:
                p = line.split()
                if not p or p[0].lower() in ("dontcare", "van") or \
                        rng.rand() < 0.15:
                    continue
                j = rng.randn(4) * 3.0
                lines.append(
                    "{} -1 -1 0.0 {:.2f} {:.2f} {:.2f} {:.2f} 0.0 0.0 0.0 "
                    "0.0 0.0 0.0 0.0 {:.3f}".format(
                        p[0].lower(), float(p[4]) + j[0], float(p[5]) + j[1],
                        float(p[6]) + j[2], float(p[7]) + j[3],
                        float(np.clip(rng.rand(), 0.05, 0.99))))
                if rng.rand() < 0.1:
                    lines.append("car -1 -1 0.0 1.00 1.00 50.00 45.00 0.0 "
                                 "0.0 0.0 0.0 0.0 0.0 0.0 {:.3f}".format(
                                     rng.rand()))
        with open(os.path.join(data_dir, idx + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return (root, len(indices), os.path.join(root, "ImageSets", "val.txt"),
            lbl_dir)


@pytest.mark.parametrize("case", sorted(CASES) + ["noisy_synth"])
def test_native_matches_python_scorer(case, binary, tmp_path):
    import subprocess
    if case == "noisy_synth":
        root, n, image_set, gt_dir = _noisy_fixture(str(tmp_path / "fx"))
    else:
        root, n, image_set, gt_dir = _case(case, tmp_path)
    res_py, res_cc = str(tmp_path / "py"), str(tmp_path / "cc")
    for res in (res_py, res_cc):
        shutil.copytree(os.path.join(root, "results"), res)
    kitti_ap.evaluate(res_py, image_set, gt_dir, n)
    subprocess.check_call([binary, os.path.join(root, "training"),
                           image_set, res_cc, str(n)],
                          stdout=subprocess.DEVNULL)
    compared = 0
    for cls in kitti_ap.CLASS_NAMES:
        py_ap = os.path.join(res_py, "stats_{}_ap.txt".format(cls))
        cc_ap = os.path.join(res_cc, "stats_{}_ap.txt".format(cls))
        assert os.path.exists(py_ap) == os.path.exists(cc_ap), cls
        if not os.path.exists(py_ap):
            continue
        compared += 1
        np.testing.assert_allclose(
            [float(line.split("=")[1]) for line in open(cc_ap)],
            [float(line.split("=")[1]) for line in open(py_ap)],
            rtol=AP_RTOL, err_msg=cls)
        for rel in ("stats_{}_detection.txt".format(cls),
                    os.path.join("plot", "{}_detection.txt".format(cls))):
            np.testing.assert_allclose(
                np.loadtxt(os.path.join(res_cc, rel)),
                np.loadtxt(os.path.join(res_py, rel)), atol=ROW_ATOL,
                err_msg=rel)
    assert compared > 0
    # the oracle test's own whole-tree comparison, nan tokens included
    _compare_trees(res_py, res_cc, case)


def test_native_build_is_keyed_by_source(binary):
    assert binary == native.build_kitti_eval()  # cached: no rebuild
    assert os.path.basename(binary).startswith("evaluate_object-")
    assert os.path.dirname(binary) == str(native.BUILD)


# -- Kitti's eval methods against the JAX Kitti -------------------------------

@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_eval"))
    make_synth_kitti(root, num_images=8, width=320, height=96,
                     image_set="val")
    return root


def _pair(root, **kw):
    cfg = st.tiny_test_config(image_width=320, image_height=96)
    jcfg = jax_tiny_config(image_width=320, image_height=96)
    return (Kitti("val", root, cfg, rng=np.random.RandomState(0), **kw),
            JaxKitti("val", root, jcfg, rng=np.random.RandomState(0), **kw))


def _all_boxes(db, seed=3):
    """Each GT box jittered, with a few misses and background boxes,
    scores from a seed: [cls][img] lists of [x1, y1, x2, y2, score]."""
    rng = np.random.RandomState(seed)
    boxes = [[[] for _ in db.image_idx] for _ in range(db.num_classes)]
    for i, idx in enumerate(db.image_idx):
        for cx, cy, w, h, cls in db._rois[idx]:
            if rng.rand() < 0.2:
                continue
            j = rng.randn(4) * 4.0
            boxes[int(cls)][i].append(
                [cx - w / 2 + j[0], cy - h / 2 + j[1], cx + w / 2 + j[2],
                 cy + h / 2 + j[3], float(rng.uniform(0.05, 0.99))])
        boxes[rng.randint(3)][i].append([10.0, 10.0, 60.0, 50.0,
                                         float(rng.rand())])
    return boxes


def test_write_detection_files_matches_jax(kitti_root, tmp_path):
    port, jax_db = _pair(kitti_root)
    boxes = _all_boxes(port)
    port.write_detection_files(str(tmp_path / "port"), boxes)
    jax_db.write_detection_files(str(tmp_path / "jax"), boxes)
    cmp = filecmp.dircmp(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert not cmp.left_only and not cmp.right_only
    assert cmp.common_files and not cmp.diff_files


@pytest.mark.parametrize("eval_tool", [None, ""])
def test_evaluate_detections_matches_jax(kitti_root, tmp_path, eval_tool):
    """Both scorers of the port give the JAX Kitti's 9 APs (the JAX side
    scores in Python); ``run_scorer`` says which one ran."""
    port, _ = _pair(kitti_root, eval_tool=eval_tool)
    _, jax_db = _pair(kitti_root, eval_tool="")
    boxes = _all_boxes(port)
    aps, names = port.evaluate_detections(str(tmp_path / "port"), 7, boxes)
    want, want_names = jax_db.evaluate_detections(str(tmp_path / "jax"), 7,
                                                  boxes)
    assert port.scorer_used == (NATIVE if eval_tool is None else PYTHON)
    assert names == want_names and len(aps) == 9
    np.testing.assert_allclose(aps, want, rtol=AP_RTOL)
    assert 0.0 < float(np.mean(aps)) < 1.0
    stats = os.path.join("detection_files_7", "stats_car_detection.txt")
    np.testing.assert_allclose(
        np.loadtxt(str(tmp_path / "port" / stats)),
        np.loadtxt(str(tmp_path / "jax" / stats)), atol=ROW_ATOL)


def protocol_max_ap(n_gt):
    """The AP of perfect detections of a class with ``n_gt`` GT boxes:
    each detection adds at most one of the 41 recall thresholds, and AP
    samples every 4th, so below 41 GT it is less than 1."""
    return sum(1 for i in range(0, 41, 4) if i < min(n_gt, 41)) / 11.0


def test_ground_truth_scores_the_protocol_maximum(kitti_root, tmp_path):
    """GT boxes as detections of score 1: every AP is the protocol's
    maximum for its class's GT count (the fixture's boxes are all level
    1, so the three difficulties agree)."""
    port, _ = _pair(kitti_root)
    boxes = [[[] for _ in port.image_idx] for _ in range(port.num_classes)]
    for i, idx in enumerate(port.image_idx):
        for cx, cy, w, h, cls in port._rois[idx]:
            # the label's corners (w = x2 - x1 + 1)
            boxes[int(cls)][i].append([cx - w / 2, cy - h / 2,
                                       cx + w / 2 - 1, cy + h / 2 - 1, 1.0])
    aps, _ = port.evaluate_detections(str(tmp_path), 0, boxes)
    assert port.scorer_used == NATIVE
    n_gt = [sum(len(b) for b in per_class) for per_class in boxes]
    assert min(n_gt) > 0
    want = [protocol_max_ap(n) for n in n_gt for _ in range(3)]
    np.testing.assert_allclose(aps, want, rtol=AP_RTOL)


def test_analysis_matches_jax(kitti_root, tmp_path):
    """``analyze_detections`` (its stats and ``det_error_file``) and
    ``do_detection_analysis_in_eval`` (stats and gallery) equal the JAX
    Kitti's on the same det files."""
    port, jax_db = _pair(kitti_root)
    boxes = _all_boxes(port, seed=5)
    for db, name in ((port, "port"), (jax_db, "jax")):
        db.write_detection_files(str(tmp_path / name / "detection_files_2" /
                                     "data"), boxes)
    stats = {}
    for db, name in ((port, "port"), (jax_db, "jax")):
        stats[name] = db.analyze_detections(
            str(tmp_path / name / "detection_files_2" / "data"),
            str(tmp_path / (name + "_errors.txt")))
    assert stats["port"] == stats["jax"]
    assert 0 < stats["port"]["% correct detections"] < 1
    with open(str(tmp_path / "port_errors.txt")) as f:
        port_errors = f.read()
    with open(str(tmp_path / "jax_errors.txt")) as f:
        assert port_errors == f.read()
    assert port_errors

    gallery = {}
    for db, name in ((port, "port"), (jax_db, "jax")):
        random.seed(0)  # the gallery shuffles the error lines
        gallery[name] = db.do_detection_analysis_in_eval(
            str(tmp_path / name), 2)
    assert gallery["port"][0] == gallery["jax"][0]
    assert len(gallery["port"][1]) == len(gallery["jax"][1]) > 0
    for a, b in zip(gallery["port"][1], gallery["jax"][1]):
        np.testing.assert_array_equal(a, b)
    err_dir = os.path.join("detection_files_2", "error_analysis")
    assert _tree(str(tmp_path / "port" / err_dir)) == \
        _tree(str(tmp_path / "jax" / err_dir))
