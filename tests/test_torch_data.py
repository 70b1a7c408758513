"""The port's host data layer against the JAX package's on the CPU: the
same KITTI fixture and the same ``RandomState`` seed give equal batch
plans over three epochs and equal arrays from every training reader; a
sampler-state snapshot continues the identical stream; the prefetch
loader's stream equals direct draws and resumes from ``consumed_state``;
the data layer decodes with OpenCV where it imports and with the port's
own PNG codec where it does not, to the same arrays; and the on-device
input paths, the train CLI included, run without cv2, PIL and jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

import squeezedet_torch as st
from squeezedet_torch.data import imdb as imdb_mod
from squeezedet_torch.data import imdb_for_dataset, png
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.data.targets import batch_to_dense_targets
from squeezedet_torch.loader import PrefetchLoader
from squeezedet_tpu.config import tiny_test_config as jax_tiny_config
from squeezedet_tpu.data import Kitti as JaxKitti
from squeezedet_tpu.data.targets import \
    batch_to_dense_targets as jax_batch_to_dense_targets
from synth_kitti import make_synth_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = dict(data_augmentation=True, drift_x=20, drift_y=20)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """7 images of two sizes, so the canvas is wider than some frames."""
    root = str(tmp_path_factory.mktemp("kitti_data"))
    a = make_synth_kitti(root, num_images=4, width=96, height=96, seed=0)
    b = make_synth_kitti(root, num_images=3, width=100, height=90, seed=1,
                         start_index=4)
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(a + b) + "\n")
    return root


def _pair(root, seed, **kw):
    cfg_kw = dict(AUG, **kw)
    port = Kitti("train", root, st.tiny_test_config().replace(**cfg_kw),
                 rng=np.random.RandomState(seed))
    ref = JaxKitti("train", root, jax_tiny_config().replace(**cfg_kw),
                   rng=np.random.RandomState(seed))
    return port, ref


def _assert_plans_equal(a, b):
    assert a.seq == b.seq and a.batch_idx == b.batch_idx
    assert a.augment == b.augment
    assert set(a.state) == set(b.state)
    for k in a.state:
        np.testing.assert_array_equal(a.state[k], b.state[k], err_msg=k)


def _assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_batch_plans_equal_over_three_epochs(kitti_root):
    port, ref = _pair(kitti_root, 3)
    # 7 images, batch 2: a reshuffle every 3 draws, so 10 draws span
    # more than three epochs
    for _ in range(10):
        _assert_plans_equal(port.draw_batch_plan(), ref.draw_batch_plan())
    assert port.canvas_size() == ref.canvas_size() == (96, 100)


@pytest.mark.parametrize("reader", [
    "read_batch_canvas", "read_batch_plan_rows", "raw_uint8", "raw_f32",
    "read_batch_canvas_cached", "read_batch_canvas_png",
    "read_batch_plan_rows_png"])
def test_readers_equal_jax(kitti_root, reader, monkeypatch):
    """Every training reader equals JAX's, decoding with OpenCV (as the
    data layer does where cv2 imports) and, the ``_png`` cases, with the
    port's own codec; with ``image_cache_mb`` the decoded frames are
    kept, read-only, and the batches do not change."""
    cached = reader.endswith("_cached")
    if reader.endswith("_png"):
        monkeypatch.setattr(imdb_mod, "_opencv", lambda: None)
    port, ref = _pair(kitti_root, 4, image_cache_mb=int(cached))
    reader = reader.replace("_cached", "").replace("_png", "")
    for _ in range(4):
        if reader.startswith("raw"):
            kw = dict(max_gt=8, uint8_images=reader == "raw_uint8")
            got = port.read_batch_raw_targets(**kw)
            want = ref.read_batch_raw_targets(**kw)
        else:
            got = getattr(port, reader)(max_gt=8)
            want = getattr(ref, reader)(max_gt=8)
        _assert_arrays_equal(got, want)
    frames = list(port._image_cache.values())
    assert bool(frames) == cached
    assert all(not f.flags.writeable for f in frames)


def test_read_frame_uses_opencv_where_it_imports(kitti_root, tmp_path,
                                                monkeypatch):
    """``read_frame`` decodes with cv2 here and names a file it cannot
    read; without cv2 it decodes with ``png.imread_png``, to the same
    pixels."""
    import cv2
    path = os.path.join(kitti_root, "training", "image_2", "000000.png")
    assert imdb_mod._opencv() is cv2
    by_cv2 = imdb_mod.read_frame(path)
    np.testing.assert_array_equal(by_cv2, cv2.imread(path))
    missing = str(tmp_path / "missing.png")
    with pytest.raises(ValueError, match="missing.png"):
        imdb_mod.read_frame(missing)

    decoded, real = [], png.imread_png

    def imread_png(p):
        decoded.append(p)
        return real(p)
    monkeypatch.setattr(imdb_mod, "_opencv", lambda: None)
    monkeypatch.setattr(imdb_mod.png, "imread_png", imread_png)
    np.testing.assert_array_equal(imdb_mod.read_frame(path), by_cv2)
    assert decoded == [path]


def test_synth_fixture_reads_as_kitti(tmp_path):
    """``data/synth.py``'s tree (libpng's adaptive row filters) reads
    through the port's Kitti as through JAX's, with 1-3 boxes a frame."""
    from squeezedet_torch.data.synth import write_kitti_fixture
    root = str(tmp_path / "synth")
    indices = write_kitti_fixture(root, 3, (96, 160), seed=2)
    assert indices == ["000000", "000001", "000002"]
    path = os.path.join(root, "training", "image_2", "000000.png")
    assert len(set(png.row_filters(path).tolist())) >= 2
    port, ref = _pair(root, 6)
    assert all(1 <= len(port._rois[i]) <= 3 for i in indices)
    for _ in range(2):
        _assert_arrays_equal(port.read_batch_canvas(max_gt=8),
                             ref.read_batch_canvas(max_gt=8))


def test_read_batch_and_dense_targets_equal_jax(kitti_root):
    port, ref = _pair(kitti_root, 5)
    cfg = port.mc
    for _ in range(3):
        got, want = port.read_batch(), ref.read_batch()
        _assert_arrays_equal(got[0], want[0])
        assert got[1] == want[1] and got[3] == want[3]
        for deltas, jax_deltas in zip(got[2], want[2]):
            np.testing.assert_array_equal(deltas, jax_deltas)
        _assert_arrays_equal(got[4], want[4])
        images, tg = batch_to_dense_targets(
            got, num_anchors=cfg.anchors, num_classes=cfg.classes)
        jimages, jtg = jax_batch_to_dense_targets(
            want, num_anchors=cfg.anchors, num_classes=cfg.classes)
        np.testing.assert_array_equal(images, jimages)
        for a, b in zip(tg, jtg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sampler_state_round_trip_continues_the_stream(kitti_root):
    """A snapshot restored into an imdb seeded otherwise continues the
    identical stream, and equals JAX's continuation of the same state."""
    a, ref = _pair(kitti_root, 7)
    for _ in range(4):
        a.read_batch_canvas(max_gt=8)
        ref.read_batch_canvas(max_gt=8)
    snap = a.sampler_state()
    expect = [a.read_batch_canvas(max_gt=8) for _ in range(4)]
    b, _ = _pair(kitti_root, 99)
    b.set_sampler_state(snap)
    for want, jax_want in zip(expect, (ref.read_batch_canvas(max_gt=8)
                                       for _ in range(4))):
        got = b.read_batch_canvas(max_gt=8)
        _assert_arrays_equal(got, want)
        _assert_arrays_equal(got, jax_want)


@pytest.mark.parametrize("mode", ["device_augment", "device_dataset",
                                  "raw_targets", "dense_targets"])
def test_prefetch_loader_stream_and_exact_resume(kitti_root, mode):
    """Three threads give the stream of direct draws, in order, and the
    consumed snapshot of item 3 resumes items 4..5 exactly."""
    kw = {"device_augment": dict(device_targets=True, device_augment=True),
          "device_dataset": dict(device_targets=True, device_dataset=True),
          "raw_targets": dict(device_targets=True, uint8_images=True),
          "dense_targets": {}}[mode]
    read = {"device_augment": "read_batch_canvas",
            "device_dataset": "read_batch_plan_rows",
            "raw_targets": "read_batch_raw_targets"}.get(mode)

    def flat(item):
        return [t.numpy() if hasattr(t, "numpy") else t for t in (
            list(item[:1]) + list(item[1]) if mode == "dense_targets"
            else item)]

    direct, _ = _pair(kitti_root, 11)
    cfg = direct.mc
    want = []
    for _ in range(5):
        if read is None:
            want.append(flat(batch_to_dense_targets(
                direct.read_batch(), num_anchors=cfg.anchors,
                num_classes=cfg.classes)))
        else:
            extra = {"uint8_images": True} if mode == "raw_targets" else {}
            want.append(flat(getattr(direct, read)(max_gt=8, **extra)))

    db, _ = _pair(kitti_root, 11)
    loader = PrefetchLoader(db, num_threads=3, capacity=2, max_gt=8,
                            **kw).start()
    try:
        got, states = [], []
        for _ in range(5):
            got.append(flat(loader.get(timeout=30)))
            states.append(loader.consumed_state())
    finally:
        loader.stop()
    for g, w in zip(got, want):
        _assert_arrays_equal(g, w)

    db2, _ = _pair(kitti_root, 123)
    db2.set_sampler_state(states[2])
    loader = PrefetchLoader(db2, num_threads=3, capacity=2, max_gt=8,
                            **kw).start()
    try:
        resumed = [flat(loader.get(timeout=30)) for _ in range(2)]
    finally:
        loader.stop()
    for g, w in zip(resumed, want[3:]):
        _assert_arrays_equal(g, w)


def test_unported_parts_name_their_roadmap_item(kitti_root):
    """Nothing of the data layer is refused any more: the native loader
    reads eval's batches (its parity: test_torch_native_loader.py) and
    the sharded sampler is ported (its plans against the JAX package's:
    test_torch_parallel.py)."""
    from squeezedet_torch.native import dataloader
    port, _ = _pair(kitti_root, 0)
    native = Kitti("train", kitti_root,
                   port.mc.replace(use_native_loader=True))
    before = dataloader.BATCHES
    images, scales = native.read_image_batch(shuffle=False)
    assert dataloader.BATCHES == before + 1
    assert len(images) == len(scales) == native.mc.batch_size
    port.shard_data(1)  # one shard is the unsharded sampler
    assert port.num_data_shards == 1
    assert isinstance(imdb_for_dataset("KITTI", "train", kitti_root,
                                       port.mc), Kitti)


_NO_CV2_TRAIN = r"""
import contextlib, io, os, sys
for name in ("cv2", "PIL", "jax", "jaxlib", "squeezedet_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np, torch
import squeezedet_torch as st
from squeezedet_torch import train as cli
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.summary import SummaryWriter
from squeezedet_torch.trainer import train

root, out = sys.argv[1], sys.argv[2]
cfg = st.tiny_test_config().replace(data_augmentation=True, drift_x=20,
                                    drift_y=20, keep_prob=1.0)
for tag in ("device_augment", "device_dataset"):
    det = st.get_model("squeezeDet", cfg, device="cpu")
    db = Kitti("train", root, cfg, rng=np.random.RandomState(0))
    state = train(det, db, train_dir=out + "/" + tag, max_steps=2,
                  checkpoint_step=100, log_every=100, device_assign=True,
                  uint8_ingest=True, max_gt=8, **{tag: True})
    assert state.step == 2

# the train CLI with tensorboard's writer on: the detection images are
# left out with one warning naming cv2, the other summaries are written
probe = SummaryWriter(out + "/probe")
assert probe.enabled
probe.close()
log = io.StringIO()
with contextlib.redirect_stdout(log):
    state = cli.main(["--device", "cpu", "--data_path", root, "--train_dir",
                      out + "/cli", "--image_width", "96", "--image_height",
                      "96", "--batch_size", "2", "--max_steps", "2",
                      "--summary_step", "1", "--histogram_step", "1",
                      "--device_assign", "--uint8_ingest",
                      "--device_augment"])
assert state.step == 2
warned = [l for l in log.getvalue().splitlines() if l.startswith("WARNING")]
assert len(warned) == 1 and "cv2" in warned[0], warned
assert any(n.startswith("events.out.tfevents")
           for n in os.listdir(out + "/cli"))
bad = [m for m in sys.modules if sys.modules[m] is not None and
       m.split(".")[0] in ("cv2", "PIL", "jax", "jaxlib", "squeezedet_tpu")]
assert not bad, bad
print("ok")
"""


def test_device_input_paths_import_no_cv2_pil_or_jax(kitti_root, tmp_path):
    """--device_augment and --device_dataset train with cv2, PIL and jax
    unimportable, and so does the train CLI with its summary writer on,
    leaving out the detection images with one warning naming cv2."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_CV2_TRAIN, kitti_root, str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
