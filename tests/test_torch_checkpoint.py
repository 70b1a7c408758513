"""The port's checkpoint manager: the filesystem contract of the JAX
package's (``model.ckpt-<step>`` directories, retention with exact-step
sampler pruning, no half-written step ever visible), a bitwise round
trip of the train state, the host copy that makes a background save safe
against the next step's in-place update, and the shape-mismatch refusal;
and the caffe-pickle import onto the detector."""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch.checkpoint.importer import load_pretrained
from squeezedet_torch.checkpoint.manager import (CheckpointManager,
                                                 all_steps, latest_step)
from squeezedet_torch.optim import build_optimizer
from squeezedet_torch.trainer import TrainState
from squeezedet_torch.weights import from_jax_params, pickle_from_jax_params


def _state(seed=0, step=3):
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    opt = build_optimizer(det.cfg, det)
    g = torch.Generator().manual_seed(seed + 1)
    for t in opt.trace.values():
        t.copy_(torch.randn(t.shape, generator=g))
    opt.step = step
    return TrainState(det, opt)


def _w(step):
    return {"w": torch.full((4,), float(step))}


def test_round_trip_is_bitwise(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state.as_tree())
    assert latest_step(str(tmp_path)) == 3
    other = _state(seed=5, step=0)
    other.load_tree(mgr.restore(3, other.as_tree()))
    assert other.step == 3
    for (n, a), b in zip(state.det.backbone.state_dict().items(),
                         other.det.backbone.state_dict().values()):
        assert torch.equal(a, b), n
    for n, t in state.opt.trace.items():
        assert torch.equal(t, other.opt.trace[n]), n
    params = mgr.restore_params(3, other.det.backbone.state_dict())
    assert torch.equal(params["conv12.weight"],
                       state.det.backbone.conv12.weight)


def test_background_save_holds_the_state_of_its_call(tmp_path):
    """save(wait=False) copies to the CPU before returning: changing the
    live tensors right after does not reach the file."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    want = {k: v.clone() for k, v in state.det.backbone.state_dict().items()}
    mgr.save(7, state.as_tree(), wait=False)
    with torch.no_grad():
        for p in state.det.backbone.parameters():
            p.add_(1.0)
    mgr.wait_until_finished()
    got = mgr.restore(7, state.as_tree())["params"]
    for n, v in want.items():
        assert torch.equal(got[n], v), n


def test_retention_bounds_dir(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, max_to_keep=3)
    for step in range(1, 9):
        mgr.save(step, _w(step))
        np.savez(os.path.join(d, "sampler.ckpt-{}.npz".format(step)),
                 cur=np.asarray(step))
    assert all_steps(d) == [6, 7, 8]
    assert latest_step(d) == 8
    samplers = sorted(n for n in os.listdir(d)
                      if n.startswith("sampler.ckpt-"))
    assert samplers == ["sampler.ckpt-6.npz", "sampler.ckpt-7.npz",
                        "sampler.ckpt-8.npz"]
    assert not [n for n in os.listdir(d) if ".pruning" in n or ".tmp" in n]
    assert torch.equal(mgr.restore(6, _w(0))["w"], _w(6)["w"])


def test_retention_exact_step_match(tmp_path):
    """Pruning step 1000 leaves sampler.ckpt-10000.npz (a live step), and
    a stale non-empty ``*.pruning`` dir is swept."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, max_to_keep=2)
    for step in (1000, 10000):
        mgr.save(step, _w(step))
        for suffix in ("", ".p0"):
            np.savez(os.path.join(d, "sampler.ckpt-{}{}.npz".format(
                step, suffix)), cur=np.asarray(step))
    stale = os.path.join(d, "model.ckpt-1000.pruning")
    os.makedirs(stale)
    with open(os.path.join(stale, "leftover"), "w") as f:
        f.write("x")

    mgr.save(20000, _w(20000))
    assert all_steps(d) == [10000, 20000]
    samplers = sorted(n for n in os.listdir(d)
                      if n.startswith("sampler.ckpt-"))
    assert samplers == ["sampler.ckpt-10000.npz",
                        "sampler.ckpt-10000.p0.npz"]
    assert not [n for n in os.listdir(d) if ".pruning" in n]


def test_latest_step_never_names_a_temporary_or_pruned_dir(tmp_path):
    d = str(tmp_path)
    CheckpointManager(d).save(3, _w(3))
    for name in ("model.ckpt-9.tmp.123", "model.ckpt-8.pruning.4",
                 "model.ckpt-7x", "model.ckpt-"):
        os.makedirs(os.path.join(d, name))
    open(os.path.join(d, "model.ckpt-11"), "w").close()  # a file, not a dir
    assert latest_step(d) == 3 and all_steps(d) == [3]


def test_polling_reader_never_sees_a_partial_step(tmp_path):
    """A reader polling latest_step + restore while the writer saves in
    the background and prunes never sees an empty dir, a step going
    backwards or a step it cannot restore."""
    d = str(tmp_path)
    writer, reader = CheckpointManager(d, max_to_keep=2), \
        CheckpointManager(d)
    writer.save(1, _w(1))
    stop, failures, seen = threading.Event(), [], []

    def poll():
        last = 0
        while not stop.is_set():
            s = latest_step(d)
            if s is None or s < last:
                failures.append("latest_step {} after {}".format(s, last))
                return
            if s != last:
                last = s
                seen.append(s)
                try:
                    if not torch.equal(reader.restore(s, _w(0))["w"],
                                       _w(s)["w"]):
                        failures.append("step {} holds other data".format(s))
                except FileNotFoundError:
                    pass  # pruned between the listing and the read
    t = threading.Thread(target=poll)
    t.start()
    try:
        for step in range(2, 12):
            writer.save(step, _w(step), wait=False)
        writer.wait_until_finished()
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive() and not failures, failures
    assert seen and latest_step(d) == 11


def test_shape_mismatch_raises(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state.as_tree())
    wide = st.get_model("squeezeDet", st.tiny_test_config(
        image_width=128, image_height=64).replace(class_names=("a", "b")),
        device="cpu")
    like = TrainState(wide, build_optimizer(wide.cfg, wide)).as_tree()
    with pytest.raises(ValueError, match="shape mismatch.*conv12"):
        mgr.restore(1, like)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore_params(1, wide.backbone.state_dict())
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, {"params": {}})


def test_caffe_pickle_loads_onto_the_detector(tmp_path, capsys):
    """A pickle made from JAX-layout params loads whole; a missing layer
    keeps its init and is printed, an extra entry is warned about."""
    src = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    from squeezedet_torch.weights import to_jax_params
    blobs = pickle_from_jax_params(to_jax_params(src.backbone.state_dict()))
    assert blobs["fire2/squeeze1x1"][0].shape == (16, 64, 1, 1)
    path = str(tmp_path / "w.pkl")
    with open(path, "wb") as f:
        pickle.dump(blobs, f)
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu")
    det.load_pretrained(load_pretrained(path))
    for (n, a), b in zip(det.backbone.state_dict().items(),
                         src.backbone.state_dict().values()):
        assert torch.equal(a, b), n

    partial = dict(blobs)
    conv12 = partial.pop("conv12")
    partial["conv13"] = conv12
    fresh = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu")
    before = fresh.backbone.conv12.weight.clone()
    fresh.load_pretrained(partial)
    out = capsys.readouterr().out
    assert "Cannot find conv12" in out and "conv13" in out
    assert torch.equal(fresh.backbone.conv12.weight, before)
    assert torch.equal(fresh.backbone.conv1.weight, src.backbone.conv1.weight)
    # a TF1 checkpoint path goes to the TF1 reader (its reads:
    # test_torch_tf1_checkpoint.py), which names the missing bundle
    with pytest.raises(FileNotFoundError, match="model.ckpt-87000.index"):
        load_pretrained(str(tmp_path / "model.ckpt-87000"))
    assert from_jax_params(to_jax_params(src.backbone.state_dict())).keys() \
        == src.backbone.state_dict().keys()


def test_summary_writer_writes_events_without_pil(tmp_path):
    """Scalars, histograms and RGB images reach the event file; images
    are PNGs from the port's own encoder."""
    import cv2
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    from squeezedet_torch.summary import SummaryWriter
    w = SummaryWriter(str(tmp_path))
    assert w.enabled
    rgb = np.random.RandomState(0).randint(0, 256, (2, 9, 13, 3)).astype(
        np.uint8)
    w.scalar("loss/total_loss", 1.5, 3)
    w.histogram("params/conv12/bias", np.arange(10.0), 3)
    w.image("sample_detection_results", rgb, 3)
    w.close()
    acc = EventAccumulator(str(tmp_path)).Reload()
    assert [e.value for e in acc.Scalars("loss/total_loss")] == [1.5]
    assert acc.Histograms("params/conv12/bias")[0].step == 3
    for i in range(2):
        (ev,) = acc.Images("sample_detection_results/image/{}".format(i))
        bgr = cv2.imdecode(np.frombuffer(ev.encoded_image_string, np.uint8),
                           cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(bgr[:, :, ::-1], rgb[i])
