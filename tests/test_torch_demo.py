"""The port's demo (``squeezedet_torch.demo``) on the CPU: image and
video modes through ``main`` as ``tests/test_demo.py`` drives the JAX
demo, the device postprocess against the host path, the final lists
against the JAX demo's on the same weights and frame, and every weight
source of ``load_params``."""

import glob
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import demo
from squeezedet_torch.checkpoint.manager import CheckpointManager
from squeezedet_torch.config import config_for_net_at
from squeezedet_torch.weights import from_jax_params, pickle_from_jax_params

# the crop [500:-205, 239:-439] removes these margins; H is odd because
# cv2's video codecs make frame sizes even (the margins sum to 705)
_CROP_TOP, _CROP_BOTTOM = 500, 205
_CROP_LEFT, _CROP_RIGHT = 239, 439
W, H = 320, 95
BOX_RTOL, BOX_ATOL, PROB_RTOL = 1e-4, 1e-3, 1e-5


@pytest.fixture(scope="module")
def params():
    """JAX params at W x H with random biases and a wider head."""
    from squeezedet_tpu.config.kitti import \
        config_for_net_at as jax_config_for_net_at
    from squeezedet_tpu.models import get_model as jax_get_model
    jdet = jax_get_model("squeezeDet",
                         jax_config_for_net_at("squeezeDet", W, H))
    tree, _, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)

    def perturb(path, p):
        if path[-1].key == "bias":
            return rng.randn(*p.shape).astype(np.float32) * 0.1
        if path[0].key == "conv12":
            return rng.randn(*p.shape).astype(np.float32) * 0.05
        return np.asarray(p)
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _argv(*extra):
    return ["--device", "cpu", "--image_width", str(W), "--image_height",
            str(H), "--checkpoint", ""] + list(extra)


def test_video_demo_writes_cropped_frames(tmp_path, capsys):
    vid = str(tmp_path / "in.avi")
    fw, fh = _CROP_LEFT + W + _CROP_RIGHT, _CROP_TOP + H + _CROP_BOTTOM
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 5,
                             (fw, fh))
    assert writer.isOpened()
    rng = np.random.RandomState(0)
    for _ in range(2):
        writer.write(rng.randint(0, 255, (fh, fw, 3), np.uint8))
    writer.release()

    out_dir = str(tmp_path / "out")
    demo.main(_argv("--mode", "video", "--input_path", vid, "--out_dir",
                    out_dir))
    outs = sorted(glob.glob(os.path.join(out_dir, "*.jpg")))
    assert [os.path.basename(p) for p in outs] == ["000001.jpg",
                                                    "000002.jpg"]
    assert cv2.imread(outs[0]).shape == (H, W, 3)
    assert capsys.readouterr().out.count("Total time: ") == 2


@pytest.mark.parametrize("extra", [[], ["--device_postprocess"]])
def test_image_demo_writes_outputs(tmp_path, extra):
    rng = np.random.RandomState(0)
    for name in ("a.png", "b.png"):
        cv2.imwrite(str(tmp_path / name),
                    rng.randint(0, 255, (64, 200, 3), np.uint8))
    out_dir = str(tmp_path / "out")
    demo.main(_argv("--input_path", str(tmp_path / "*.png"), "--out_dir",
                    out_dir, *extra))
    for name in ("a.png", "b.png"):
        im = cv2.imread(os.path.join(out_dir, "out_" + name))
        assert im.shape == (H, W, 3)


def _frame(seed=0):
    return np.random.RandomState(seed).randn(H, W, 3).astype(np.float32) * 40


def test_filter_outputs_device_matches_host(params):
    cfg = config_for_net_at("squeezeDet", W, H).replace(
        batch_size=1, plot_prob_thresh=0.01)
    det = st.get_model("squeezeDet", cfg, device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    im = _frame()
    host = demo._filter_outputs(det, demo._predict(det, im, False), cfg,
                                False)
    dev = demo._filter_outputs(det, demo._predict(det, im, True), cfg, True)
    assert len(host[0]) > 0
    assert dev[2] == list(host[2])
    np.testing.assert_allclose(dev[1], host[1], rtol=PROB_RTOL)
    np.testing.assert_allclose(np.asarray(dev[0]), np.asarray(host[0]),
                               rtol=BOX_RTOL, atol=BOX_ATOL)


@pytest.mark.parametrize("device_pp", [False, True])
def test_final_lists_match_jax_demo(params, device_pp):
    """The (boxes, probs, classes) the demo draws equal the JAX demo's
    for the same weights and frame."""
    import jax.numpy as jnp

    from squeezedet_tpu import demo as jax_demo
    from squeezedet_tpu.config.kitti import \
        config_for_net_at as jax_config_for_net_at
    from squeezedet_tpu.models import get_model as jax_get_model
    jcfg = jax_config_for_net_at("squeezeDet", W, H).replace(
        batch_size=1, plot_prob_thresh=0.01)
    jdet = jax_get_model("squeezeDet", jcfg)
    cfg = config_for_net_at("squeezeDet", W, H).replace(
        batch_size=1, plot_prob_thresh=0.01)
    det = st.get_model("squeezeDet", cfg, device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    im = _frame(1)
    if device_pp:
        out = jax.jit(lambda p, x: jdet.postprocess_device(
            jdet.predict(p, x)))(params, jnp.asarray(im[None]))
    else:
        out = jax.jit(jdet.predict)(params, jnp.asarray(im[None]))
    want = jax_demo._filter_outputs(jdet, out, jcfg, device_pp)
    got = demo._filter_outputs(det, demo._predict(det, im, device_pp), cfg,
                               device_pp)
    assert len(want[0]) > 0
    assert list(got[2]) == list(want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=PROB_RTOL)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=BOX_RTOL, atol=BOX_ATOL)


def _detector():
    return st.get_model("squeezeDet", config_for_net_at(
        "squeezeDet", W, H), device="cpu",
        generator=torch.Generator().manual_seed(5))


def test_load_params_from_each_source(params, tmp_path, capsys):
    want = from_jax_params(params)
    CheckpointManager(str(tmp_path / "ckpt")).save(4, {"params": want})
    CheckpointManager(str(tmp_path / "ckpt")).save(
        2, {"params": _detector().backbone.state_dict()})
    import pickle
    with open(str(tmp_path / "w.pkl"), "wb") as f:
        pickle.dump(pickle_from_jax_params(params), f)
    for source in (str(tmp_path / "ckpt"), str(tmp_path / "w.pkl")):
        det = demo.load_params(_detector(), source)
        for name, p in det.backbone.state_dict().items():
            torch.testing.assert_close(p, want[name], rtol=0, atol=0)
    out = capsys.readouterr().out
    assert "Restored step 4" in out and "Imported legacy weights" in out

    seeded = _detector().backbone.state_dict()
    det = demo.load_params(_detector(), "none")
    for name, p in det.backbone.state_dict().items():
        assert torch.equal(p, seeded[name])
    assert "random weights" in capsys.readouterr().out
    os.makedirs(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        demo.load_params(_detector(), str(tmp_path / "empty"))
    # a TF1 checkpoint path goes to the TF1 reader (its reads:
    # test_torch_tf1_checkpoint.py), which names the missing bundle
    with pytest.raises(FileNotFoundError, match="model.ckpt-100.index"):
        demo.load_params(_detector(), str(tmp_path / "model.ckpt-100"))


@pytest.mark.parametrize("flag,error,match", [
    (["--demo_net", "resnet50"], SystemExit, "not supported"),
    (["--demo_net", "vgg7"], SystemExit, "not supported"),
])
def test_unported_options_name_their_roadmap_item(flag, error, match,
                                                  tmp_path):
    with pytest.raises(error, match=match):
        demo.main(_argv("--out_dir", str(tmp_path)) + flag)


def test_cuda_without_cuda_exits(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA device"):
        demo.main(["--checkpoint", "", "--out_dir", str(tmp_path)])
