"""The port's native batch loader (``squeezedet_torch/native/dataloader``)
against the port's Python reader and against the JAX package's native
loader (``squeezedet_tpu/native/dataloader``, built from its source into
this test's directory), at the tolerances of ``tests/test_native_loader.py``:
pixels within 5e-3 (the two sides subtract the means in float32 and
float64), scales to rtol 1e-6, GT boxes to rtol 1e-5; the refusals; and
the train and eval CLIs with ``--native_loader``.

The JAX library links the system's OpenCV, whose float resize takes its
sample positions in float32 and lands up to 1.4e-2 from the bilinear
that ``cv2.resize`` (OpenCV's IPP path) and the port's library compute
at KITTI's 1242x375 -> 1248x384; so the JAX library is held to at the
JAX test's 400x140 -> 320x96 and the Python reader at both sizes."""

import os
import subprocess

import numpy as np
import pytest

import squeezedet_torch as st
from squeezedet_torch import eval as port_eval
from squeezedet_torch import train as port_cli
from squeezedet_torch.data import imdb as imdb_mod
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.native import dataloader
from squeezedet_tpu.config import tiny_test_config as jax_tiny_config
from squeezedet_tpu.data import Kitti as JaxKitti
from squeezedet_tpu.native import dataloader as jax_ndl
from synth_kitti import make_synth_kitti
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_ATOL, SCALE_RTOL, BOX_RTOL, BOX_ATOL = 5e-3, 1e-6, 1e-5, 1e-4


@pytest.fixture(scope="module")
def jax_loader(tmp_path_factory):
    """The JAX package's loader library, compiled from its source with its
    Makefile's flags into this module's directory (not in place, where
    its own tests build it)."""
    src = os.path.join(REPO, "squeezedet_tpu", "native", "dataloader")
    lib = str(tmp_path_factory.mktemp("jax_sdl") / "libsdloader.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC",
                    "-I/usr/include/opencv4", "-shared", "-o", lib,
                    os.path.join(src, "loader.cc"), "-lopencv_imgcodecs",
                    "-lopencv_imgproc", "-lopencv_core"], check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_ndl, "_LIB_PATH", lib)
    mp.setattr(jax_ndl, "_lib", None)
    assert jax_ndl.available()
    yield jax_ndl
    mp.undo()


@pytest.fixture(scope="module", params=["small", "kitti"])
def kitti_root(request, tmp_path_factory):
    """Frames of the JAX test's size (400x140, a downscale to 320x96) or
    KITTI's (1242x375, an upscale to 1248x384)."""
    root = str(tmp_path_factory.mktemp("kitti_native"))
    if request.param == "small":
        make_synth_kitti(root, num_images=5, width=400, height=140)
        return root, dict(image_width=320, image_height=96, batch_size=4)
    make_synth_kitti(root, num_images=3, width=1242, height=375)
    return root, dict(image_width=1248, image_height=384, batch_size=3)


def _readers(root, size, seed, **kw):
    """The port's Python and native readers and the JAX native reader on
    one fixture, each with its own RandomState(seed)."""
    cfg = st.tiny_test_config(**size).replace(**kw)
    jcfg = jax_tiny_config(**size).replace(use_native_loader=True, **kw)
    return (Kitti("train", root, cfg, rng=np.random.RandomState(seed)),
            Kitti("train", root, cfg.replace(use_native_loader=True),
                  rng=np.random.RandomState(seed)),
            JaxKitti("train", root, jcfg, rng=np.random.RandomState(seed)))


def test_eval_batch_matches_python_and_jax(jax_loader, kitti_root):
    root, size = kitti_root
    py, nat, jax_nat = _readers(root, size, 0)
    before = dataloader.BATCHES
    p_images, p_scales = py.read_image_batch(shuffle=False)
    n_images, n_scales = nat.read_image_batch(shuffle=False)
    j_images, j_scales = jax_nat.read_image_batch(shuffle=False)
    assert dataloader.BATCHES == before + 1
    for p, n, j in zip(p_images, n_images, j_images):
        assert n.dtype == np.float32 and n.shape == p.shape
        np.testing.assert_allclose(n, p, atol=PIXEL_ATOL, rtol=0)
        if size["image_width"] == 320:
            np.testing.assert_allclose(n, j, atol=PIXEL_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(n_scales), np.asarray(p_scales),
                               rtol=SCALE_RTOL)
    np.testing.assert_allclose(np.asarray(n_scales), np.asarray(j_scales),
                               rtol=SCALE_RTOL)


def test_train_batch_matches_python_and_jax_with_augmentation(jax_loader,
                                                              kitti_root):
    root, size = kitti_root
    py, nat, jax_nat = _readers(root, size, 5, data_augmentation=True,
                                drift_x=30, drift_y=20)
    for _ in range(3):  # several batches, several draws of the sampler
        p = py.read_batch_raw_targets(shuffle=False, max_gt=8)
        n = nat.read_batch_raw_targets(shuffle=False, max_gt=8)
        j = jax_nat.read_batch_raw_targets(shuffle=False, max_gt=8)
        for want in (p, j):
            np.testing.assert_array_equal(n[3], want[3])
            np.testing.assert_array_equal(n[2], want[2])
            np.testing.assert_allclose(n[1], want[1], rtol=BOX_RTOL,
                                       atol=BOX_ATOL)
            if want is p or size["image_width"] == 320:
                np.testing.assert_allclose(n[0], want[0], atol=PIXEL_ATOL,
                                           rtol=0)
    for key, value in py.sampler_state().items():
        np.testing.assert_array_equal(nat.sampler_state()[key], value)


def test_uint8_feed_stays_in_python(tmp_path):
    """The loader reads f32 pixels only: the uint8 feed keeps the Python
    reader, as in the JAX package."""
    make_synth_kitti(str(tmp_path), num_images=2, width=96, height=96)
    cfg = st.tiny_test_config(batch_size=2).replace(use_native_loader=True)
    before = dataloader.BATCHES
    images, *_ = Kitti("train", str(tmp_path), cfg).read_batch_raw_targets(
        uint8_images=True)
    assert images.dtype == np.uint8 and dataloader.BATCHES == before


def test_missing_and_non_png_files_are_named(tmp_path):
    import cv2
    jpg = str(tmp_path / "frame.jpg")
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    missing = str(tmp_path / "nope.png")
    with pytest.raises(IOError, match="nope.png cannot be read"):
        dataloader.load_image_batch([missing], 32, 32, np.zeros(3), 1)
    with pytest.raises(IOError, match="frame.jpg is not a PNG"):
        dataloader.load_train_batch([jpg], 32, 32, np.zeros(3),
                                    np.zeros((1, 2)), np.zeros(1), 1)


def test_library_that_cannot_build_raises(tmp_path, monkeypatch):
    """No fallback: a loader that cannot build raises with the compiler's
    error, and the CLIs exit non-zero naming the flag."""
    monkeypatch.setattr(dataloader, "_lib", None)
    monkeypatch.setattr(dataloader, "library_path",
                        lambda: tmp_path / "libsdloader-x.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="needs g\\+\\+ and zlib"):
        dataloader.load()
    with pytest.raises(SystemExit, match="--native_loader"):
        port_cli.main(["--device", "cpu", "--train_dir",
                       str(tmp_path / "tr"), "--native_loader"])
    with pytest.raises(SystemExit, match="--native_loader"):
        port_eval.main(["--device", "cpu", "--checkpoint_path",
                        str(tmp_path), "--native_loader"])


def test_train_and_eval_clis_read_through_the_loader(tmp_path, monkeypatch):
    """The train CLI's --device_assign feed and the eval CLI's reader load
    every batch through the library: the Python decoder never runs."""
    root = str(tmp_path / "kitti")
    make_synth_kitti(root, num_images=4, width=96, height=96)
    decodes = []
    monkeypatch.setattr(imdb_mod, "read_frame",
                        lambda path: decodes.append(path))
    before = dataloader.BATCHES
    size = ["--image_width", "96", "--image_height", "96"]
    state = port_cli.main(["--device", "cpu", "--data_path", root,
                           "--train_dir", str(tmp_path / "tr"),
                           "--batch_size", "2", "--max_steps", "2",
                           "--checkpoint_step", "2", "--summary_step", "0",
                           "--device_assign", "--native_loader"] + size)
    assert state.step == 2 and decodes == []
    assert dataloader.BATCHES - before >= 2
    before = dataloader.BATCHES
    port_eval.main(["--device", "cpu", "--data_path", root,
                    "--image_set", "train", "--checkpoint_path",
                    str(tmp_path / "tr"), "--eval_dir",
                    str(tmp_path / "ev"), "--run_once", "--eval_batch_size",
                    "2", "--skip_analysis", "--native_loader"] + size)
    assert decodes == [] and dataloader.BATCHES - before == 2
