"""The port's eval (``squeezedet_torch.eval``) against the JAX package's
on the CPU.

Both packages run the same weights: JAX params from ``det.init`` with
random biases and a rescaled head (so scores are spread out and top-K
ranks and NMS choices are not near-ties), loaded into the port with
``weights.from_jax_params``.  ``detect_all`` of both gives equal
detection counts per class and image, and boxes and scores within
rtol 1e-4, atol 1e-3 (``tests/test_eval_dp.py``'s tolerance): f32 sums
in other orders.  The JAX side runs on its 8-device CPU mesh, which that
test holds to the single-device scan.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import eval as port_eval
from squeezedet_torch.checkpoint.manager import CheckpointManager
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.weights import from_jax_params
from squeezedet_tpu import eval as jax_eval
from squeezedet_tpu.config import tiny_test_config as jax_tiny_config
from squeezedet_tpu.data import Kitti as JaxKitti
from squeezedet_tpu.models import get_model as jax_get_model
from synth_kitti import make_synth_kitti

RTOL, ATOL = 1e-4, 1e-3
HEAD_STD, BIAS_STD = 0.05, 0.1


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_eval_cli"))
    make_synth_kitti(root, num_images=8, width=320, height=96,
                     image_set="val")
    return root


@pytest.fixture(scope="module")
def params():
    """JAX params with random biases and a wider head, as numpy."""
    jdet = jax_get_model("squeezeDet",
                         jax_tiny_config(image_width=320, image_height=96))
    tree, _, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)

    def perturb(path, p):
        if path[-1].key == "bias":
            return rng.randn(*p.shape).astype(np.float32) * BIAS_STD
        if path[0].key == "conv12":
            return rng.randn(*p.shape).astype(np.float32) * HEAD_STD
        return np.asarray(p)
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _models(params, width, height, batch):
    jcfg = jax_tiny_config(image_width=width, image_height=height,
                           batch_size=batch)
    det = st.get_model("squeezeDet", st.tiny_test_config(
        image_width=width, image_height=height, batch_size=batch),
        device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    return jax_get_model("squeezeDet", jcfg), jcfg, det


def _assert_same_detections(got, want, num_images):
    assert len(got) == len(want)
    for c in range(len(want)):
        for i in range(num_images):
            a = np.asarray(sorted(map(tuple, want[c][i])))
            b = np.asarray(sorted(map(tuple, got[c][i])))
            assert a.shape == b.shape, (c, i)
            if a.size:
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("width,height,batch,device_pp", [
    (320, 96, 1, False),   # the reference protocol: host postprocess
    (256, 80, 1, False),   # rescale to 320x96 after the host filter
    (256, 80, 1, True),    # filter at model resolution, then rescale
    (256, 80, 8, True),    # the batched default
    (320, 96, 3, True),    # 3 batches of 3 over 8 images: tail dropped
])
def test_detect_all_matches_jax(kitti_root, params, width, height, batch,
                                device_pp):
    jdet, jcfg, det = _models(params, width, height, batch)
    want, want_n, _ = jax_eval.detect_all(
        jdet, JaxKitti("val", kitti_root, jcfg), params, batch,
        device_postprocess=device_pp)
    db = Kitti("val", kitti_root, det.cfg)
    got, got_n, timers = port_eval.detect_all(det, db, batch,
                                              device_postprocess=device_pp)
    assert got_n == want_n > 0
    _assert_same_detections(got, want, len(db.image_idx))
    assert timers['im_detect'].calls == -(-8 // batch)


@pytest.mark.parametrize("batch", [1, 8])
def test_detect_all_device_dataset_matches_jax(kitti_root, params, batch):
    """At the identity geometry the on-device resize is exact, so the
    device-resident split gives the host reader's detections; a second
    poll reuses the uploaded stack and another key uploads again."""
    jdet, jcfg, det = _models(params, 320, 96, batch)
    want, want_n, _ = jax_eval.detect_all(
        jdet, JaxKitti("val", kitti_root, jcfg), params, batch,
        device_dataset=True)
    db = Kitti("val", kitti_root, det.cfg)
    got, got_n, _ = port_eval.detect_all(det, db, batch,
                                         device_postprocess=batch > 1,
                                         device_dataset=True)
    key, (stack,) = db._eval_stack_dev  # one stack per replica
    assert key == "cpu" and stack.dtype == torch.uint8
    assert stack.shape == (8, 96, 320, 3)
    again, again_n, _ = port_eval.detect_all(det, db, batch,
                                             device_postprocess=batch > 1,
                                             device_dataset=True)
    assert db._eval_stack_dev[1][0] is stack
    db._eval_stack_dev = ("stale-device", [stack])
    port_eval.detect_all(det, db, batch, device_dataset=True)
    assert db._eval_stack_dev[0] == "cpu"
    assert db._eval_stack_dev[1][0] is not stack
    assert got_n == again_n == want_n > 0
    _assert_same_detections(got, want, 8)
    _assert_same_detections(again, want, 8)


def test_device_dataset_memory_guard(kitti_root, params, monkeypatch):
    _, _, det = _models(params, 320, 96, 1)
    db = Kitti("val", kitti_root, det.cfg)
    monkeypatch.setattr(type(db), "canvas_size",
                        lambda self: (40000, 40000))
    with pytest.raises(ValueError, match="GiB per device"):
        port_eval.detect_all(det, db, 1, device_dataset=True)


def test_detect_all_refuses_another_batch_than_the_reader(kitti_root,
                                                         params):
    _, _, det = _models(params, 320, 96, 1)
    with pytest.raises(ValueError, match="reads 1 images"):
        port_eval.detect_all(det, Kitti("val", kitti_root, det.cfg), 8)


def test_eval_readers_match_jax(kitti_root):
    """``read_image_batch`` and ``read_image_rows`` give the JAX
    readers' arrays, both after ``reset_cursor`` and across the wrap."""
    cfg = st.tiny_test_config(image_width=256, image_height=80,
                              batch_size=3)
    port = Kitti("val", kitti_root, cfg)
    jdb = JaxKitti("val", kitti_root, jax_tiny_config(
        image_width=256, image_height=80, batch_size=3))
    for _ in range(2):
        for _ in range(4):  # 12 rows over 8 images: wraps once
            got, want = port.read_image_batch(shuffle=False), \
                jdb.read_image_batch(shuffle=False)
            np.testing.assert_array_equal(np.stack(got[0]),
                                          np.stack(want[0]))
            assert got[1] == want[1]
        port.reset_cursor()
        jdb.reset_cursor()
    for _ in range(4):
        got, want = port.read_image_rows(), jdb.read_image_rows()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_read_image_batch_without_cv2_names_device_dataset(kitti_root,
                                                           monkeypatch):
    from squeezedet_torch.data import imdb
    db = Kitti("val", kitti_root,
               st.tiny_test_config(image_width=320, image_height=96))
    monkeypatch.setattr(imdb, "_opencv", lambda: None)
    with pytest.raises(ImportError, match="--device_dataset"):
        db.read_image_batch(shuffle=False)
    assert len(db.read_image_rows()[0]) == 2


def _read_aps(eval_dir, step):
    out = {}
    result_dir = os.path.join(eval_dir, "detection_files_{}".format(step))
    for cls in ("car", "pedestrian", "cyclist"):
        path = os.path.join(result_dir, "stats_{}_ap.txt".format(cls))
        if os.path.exists(path):
            out[cls] = [float(line.split("=")[1]) for line in open(path)]
    return out


def _line_counts(eval_dir, step):
    data = os.path.join(eval_dir, "detection_files_{}".format(step), "data")
    return {name: len(open(os.path.join(data, name)).readlines())
            for name in sorted(os.listdir(data))}


def test_eval_cli_matches_jax(kitti_root, params, tmp_path, capsys):
    """``eval.main --run_once`` of both packages on the same weights: the
    JAX CLI reads them from an orbax checkpoint, the port's from a port
    checkpoint.  Same APs within 1e-3, same detection lines per file."""
    from squeezedet_tpu.checkpoint.manager import \
        CheckpointManager as JaxCheckpointManager
    JaxCheckpointManager(str(tmp_path / "jax_ckpt")).save(
        5, {"params": params})
    CheckpointManager(str(tmp_path / "port_ckpt")).save(
        5, {"params": from_jax_params(params)})
    common = ["--data_path", kitti_root, "--image_set", "val", "--run_once",
              "--image_width", "320", "--image_height", "96",
              "--eval_batch_size", "8"]
    jax_eval.main(common + ["--checkpoint_path", str(tmp_path / "jax_ckpt"),
                            "--eval_dir", str(tmp_path / "jax_eval")])
    port_eval.main(common + ["--device", "cpu", "--checkpoint_path",
                             str(tmp_path / "port_ckpt"), "--eval_dir",
                             str(tmp_path / "port_eval"), "--plot_pr"])
    out = capsys.readouterr().out
    assert "Evaluating step 5" in out and "Scored by the native scorer" in out
    want, got = (_read_aps(str(tmp_path / "jax_eval"), 5),
                 _read_aps(str(tmp_path / "port_eval"), 5))
    assert sorted(got) == sorted(want) and got
    for cls in want:
        np.testing.assert_allclose(got[cls], want[cls], atol=1e-3)
    assert _line_counts(str(tmp_path / "port_eval"), 5) == \
        _line_counts(str(tmp_path / "jax_eval"), 5)
    plot = os.path.join(str(tmp_path / "port_eval"), "detection_files_5",
                        "plot")
    assert any(n.endswith(".png") for n in os.listdir(plot))
    assert os.path.exists(os.path.join(
        str(tmp_path / "port_eval"), "detection_files_5", "error_analysis",
        "det_error_file.txt"))


def test_daemon_polls_and_scores_each_step_once(kitti_root, tmp_path,
                                                monkeypatch, capsys):
    argv = ["--device", "cpu", "--data_path", kitti_root, "--image_set",
            "val", "--image_width", "320", "--image_height", "96",
            "--checkpoint_path", str(tmp_path / "ckpt"), "--eval_dir",
            str(tmp_path / "eval"), "--eval_interval_secs", "7"]
    port_eval.main(argv + ["--run_once"])  # no checkpoint: returns
    assert "No checkpoint file found" in capsys.readouterr().out

    det = st.get_model("squeezeDet",
                       st.tiny_test_config(image_width=320, image_height=96),
                       device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(
        3, {"params": det.backbone.state_dict()})
    scored, sleeps = [], []

    class Stop(Exception):
        pass

    def sleep(secs):
        sleeps.append(secs)
        if len(sleeps) == 3:
            raise Stop

    monkeypatch.setattr(time, "sleep", sleep)
    monkeypatch.setattr(port_eval, "eval_checkpoint",
                        lambda det, imdb, step, **kw: scored.append(step))
    with pytest.raises(Stop):
        port_eval.main(argv)
    assert scored == [3] and sleeps == [7, 7, 7]


@pytest.mark.parametrize("flag,item", [
    pytest.param(["--compilation_cache", "x"], "item 14",
                 id="flag1-item 14")])
def test_unported_flags_name_their_roadmap_item(flag, item, tmp_path):
    with pytest.raises(SystemExit, match=item):
        port_eval.main(["--device", "cpu", "--checkpoint_path",
                        str(tmp_path)] + flag)


def test_cuda_without_cuda_exits(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_eval.main(["--checkpoint_path", str(tmp_path)])


def test_device_postprocess_default():
    p = port_eval.build_arg_parser()

    def resolved(argv):
        return port_eval.resolve_device_postprocess(p.parse_args(argv))

    assert resolved(['--eval_batch_size', '8']) is True
    assert resolved([]) is False
    assert resolved(['--device_postprocess']) is True
    assert resolved(['--eval_batch_size', '8', '--host_postprocess']) is False
