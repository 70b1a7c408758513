"""The port's train loop and train CLI against the JAX package's on the
CPU.

``train()`` of both packages starts from the same caffe-pickle weights
(made from JAX params with random biases and a 0.05 head), the same
``RandomState`` seed and fixture, with ``keep_prob=1`` (the two
frameworks draw different dropout bits from a seed), 3 steps each, in
the ``--device_assign --uint8_ingest --device_augment`` path and in the
host-target path.  Per-step losses agree to rtol 1e-4.  Final params
agree to STEP_TOL = 2e-2 of each leaf's update norm (L2), as
``chip_smoke.py`` holds the card against the CPU: a weight gradient is
an f32 sum over B*H*W positions whose terms mostly cancel, the two
packages sum in other orders, and three momentum steps carry the
difference on, while a wrong routing or layout is off by O(1).
"""

import os

import jax
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import train as port_cli
from squeezedet_torch.checkpoint.manager import CheckpointManager
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.models import layers as TL
from squeezedet_torch.ops import filter_grad as fg
from squeezedet_torch.trainer import train
from squeezedet_torch.weights import (checkpoint_to_jax_tree,
                                      from_jax_params, pickle_from_jax_params)
from squeezedet_tpu import train as jax_cli
from squeezedet_tpu.config import tiny_test_config as jax_tiny_config
from squeezedet_tpu.data import Kitti as JaxKitti
from squeezedet_tpu.models import get_model as jax_get_model
from squeezedet_tpu.trainer import train as jax_train
from synth_kitti import make_synth_kitti
from torch_threads import one_thread  # noqa: F401  (autouse)

LOSS_RTOL, STEP_TOL = 1e-4, 2e-2
CFG_KW = dict(keep_prob=1.0, data_augmentation=True, drift_x=20,
              drift_y=20)


class RecordingWriter:
    """A summary writer that keeps what it is given."""

    def __init__(self):
        self.scalars, self.histograms, self.images = {}, {}, {}

    def scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))

    def histogram(self, tag, values, step, buckets=None):
        self.histograms.setdefault(tag, []).append((step, values))

    def image(self, tag, images, step, max_outputs=20):
        self.images.setdefault(tag, []).append((step, images))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_loop"))
    make_synth_kitti(root, num_images=5, width=96, height=96)
    return root


@pytest.fixture(scope="module")
def start():
    """JAX params with random biases and a 0.05 head, and the same as a
    caffe pickle."""
    jdet = jax_get_model("squeezeDet", jax_tiny_config().replace(**CFG_KW))
    params, _, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)

    def perturb(path, p):
        if path[-1].key == "bias":
            return rng.randn(*p.shape).astype(np.float32) * 0.1
        if path[0].key == "conv12":
            return rng.randn(*p.shape).astype(np.float32) * 0.05
        return np.asarray(p)
    params = jax.tree_util.tree_map_with_path(perturb, params)
    return params, pickle_from_jax_params(params)


def _losses(writer):
    return [v for _, v in writer.scalars["loss/total_loss"]]


@pytest.mark.parametrize("mode", ["device_augment", "host_targets"])
def test_train_matches_jax(kitti_root, start, tmp_path, mode):
    params, blobs = start
    kw = dict(max_steps=3, checkpoint_step=100, summary_step=1,
              log_every=1, seed=0, pretrained=blobs, max_gt=8)
    if mode == "device_augment":
        kw.update(device_assign=True, uint8_ingest=True,
                  device_augment=True)
    jw, pw = RecordingWriter(), RecordingWriter()
    jstate = jax_train(
        jax_get_model("squeezeDet", jax_tiny_config().replace(**CFG_KW)),
        JaxKitti("train", kitti_root, jax_tiny_config().replace(**CFG_KW),
                 rng=np.random.RandomState(2)),
        train_dir=str(tmp_path / "jax"), summary_writer=jw, **kw)
    det = st.get_model("squeezeDet", st.tiny_test_config().replace(**CFG_KW),
                       device="cpu")
    state = train(det, Kitti("train", kitti_root, det.cfg,
                             rng=np.random.RandomState(2)),
                  train_dir=str(tmp_path / "port"), summary_writer=pw, **kw)
    assert state.step == jstate.step == 3

    np.testing.assert_allclose(_losses(pw), _losses(jw), rtol=LOSS_RTOL)
    assert [s for s, _ in pw.scalars["loss/total_loss"]] == [0, 1, 2]
    before = from_jax_params(params)
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    for name, p in det.backbone.state_dict().items():
        moved = (want[name] - before[name]).norm()
        err = (p - want[name]).norm()
        assert err <= STEP_TOL * moved, (name, float(err), float(moved))

    # the model accounting is the JAX package's, to the byte
    with open(tmp_path / "port" / "model_metrics.txt") as f, \
            open(tmp_path / "jax" / "model_metrics.txt") as g:
        assert f.read() == g.read()

    # the port's final checkpoint, as a JAX tree, is shaped as JAX's
    tree = CheckpointManager(str(tmp_path / "port")).restore(
        2, state.as_tree())
    ours = checkpoint_to_jax_tree(tree, jstate.opt_state)
    theirs = jstate.as_tree()
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert np.shape(a) == np.shape(b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _port_run(root, train_dir, max_steps, seed=3, summary_step=1000, **kw):
    cfg = st.tiny_test_config().replace(data_augmentation=True, drift_x=20,
                                        drift_y=12, num_thread=3)
    det = st.get_model("squeezeDet", cfg, device="cpu")
    db = Kitti("train", root, cfg, rng=np.random.RandomState(seed))
    return train(det, db, train_dir=train_dir, max_steps=max_steps,
                 checkpoint_step=100, summary_step=summary_step, log_every=1,
                 device_assign=True, max_gt=8, seed=11, **kw)


def test_device_dataset_equals_canvas_feed(kitti_root, tmp_path):
    """The device-resident stack and its on-device gather add nothing to
    the stream: --device_dataset trains what --device_augment's per-step
    canvas feed trains, bit for bit on the CPU (dropout on)."""
    a = _port_run(kitti_root, str(tmp_path / "ds"), 3, device_dataset=True)
    b = _port_run(kitti_root, str(tmp_path / "cv"), 3, device_augment=True)
    for (n, p), q in zip(a.det.backbone.state_dict().items(),
                         b.det.backbone.state_dict().values()):
        assert torch.equal(p, q), n


def test_resume_is_bit_exact(kitti_root, tmp_path, capsys):
    """4 steps straight equal 2 steps plus a 2-step resume, bit for bit
    on the CPU: the consumed batch's sampler snapshot and the dropout
    generator's state continue both streams."""
    straight = _port_run(kitti_root, str(tmp_path / "a"), 4)
    _port_run(kitti_root, str(tmp_path / "b"), 2)
    resumed = _port_run(kitti_root, str(tmp_path / "b"), 4, seed=77)
    out = capsys.readouterr().out
    assert "Resumed from step 2" in out
    assert "Restored input-stream state (sampler.ckpt-1.npz)" in out
    assert resumed.step == straight.step == 4
    for (n, p), q in zip(straight.det.backbone.state_dict().items(),
                         resumed.det.backbone.state_dict().values()):
        assert torch.equal(p, q), n
    for n, t in straight.opt.trace.items():
        assert torch.equal(t, resumed.opt.trace[n]), n


def test_cli_trains_checkpoints_and_resumes(kitti_root, tmp_path):
    """``python -m squeezedet_torch.train --device cpu``: K2's routing is
    on for the run under --pallas_grads and off again after; retention keeps the newest 2
    steps and their sampler files; histograms and detection images are
    written on summary steps; a second call resumes."""
    train_dir = str(tmp_path / "cli")
    argv = ["--device", "cpu", "--data_path", kitti_root, "--train_dir",
            train_dir, "--image_width", "96", "--image_height", "96",
            "--batch_size", "2", "--checkpoint_step", "1",
            "--max_to_keep", "2", "--device_assign", "--uint8_ingest",
            "--device_augment", "--pallas_grads", "--learning_rate",
            "0.001", "--histogram_step", "2", "--summary_step", "2"]
    calls = []
    real = fg.filter_grad

    def spy(*args):
        calls.append(args[2:])
        return real(*args)
    fg.filter_grad = spy
    try:
        state = port_cli.main(argv + ["--max_steps", "3"])
    finally:
        fg.filter_grad = real
    # at 96x96 "1x1" mode routes fire5's squeeze (C=128, 12x12 = 144
    # positions) alone: its 2 conv2d_pair halves in each of 3 train
    # backwards and 2 histogram recomputes
    assert len(calls) == 2 * 5 and set(calls) == {(1, 1)}
    assert TL.filter_grad_mode() is False
    assert state.step == 3
    names = sorted(os.listdir(train_dir))
    assert [n for n in names if n.startswith(("model.ckpt", "sampler"))] \
        == ["model.ckpt-1", "model.ckpt-2", "sampler.ckpt-1.npz",
            "sampler.ckpt-2.npz"]
    assert "model_metrics.txt" in names
    assert any(n.startswith("events.out.tfevents") for n in names)
    state = port_cli.main(argv + ["--max_steps", "4"])
    assert state.step == 4


def test_histograms_and_detection_images(kitti_root, tmp_path):
    """Summary steps write the JAX package's histogram tags (trainable
    leaves only: conv1 is frozen) and RGB detection images."""
    w = RecordingWriter()
    _port_run(kitti_root, str(tmp_path / "h"), 2, device_augment=True,
              summary_writer=w, viz_step=1, histogram_step=1)
    assert "params/fire2/squeeze1x1/kernel" in w.histograms
    assert "gradients/conv12/bias" in w.histograms
    assert not any("conv1/" in t for t in w.histograms)
    (step, ims), = w.images["sample_detection_results"][:1]
    assert step == 0 and ims.dtype == np.uint8 and ims.shape[1:] == (96, 96,
                                                                     3)


def test_summary_step_zero_writes_no_summaries(kitti_root, tmp_path):
    """--summary_step 0 turns the summaries off (the JAX loop divides by
    it); histograms keep their own cadence."""
    w = RecordingWriter()
    state = _port_run(kitti_root, str(tmp_path / "z"), 2,
                      device_augment=True, summary_writer=w, viz_step=0,
                      summary_step=0, histogram_step=1)
    assert state.step == 2
    assert not w.scalars and not w.images
    assert "params/conv12/kernel" in w.histograms


def _cfg_fields(cfg):
    out = dict(vars(cfg))
    out["anchor_box"] = np.asarray(out["anchor_box"]).tolist()
    return out


@pytest.mark.parametrize("argv", [
    ['--batch_size', '16', '--learning_rate', '0.001', '--max_steps', '375'],
    ['--batch_size', '16', '--learning_rate', '0.001', '--max_steps', '375',
     '--recipe_batch', '128'],
    ['--batch_size', '16', '--learning_rate', '0.001', '--max_steps', '375',
     '--recipe_batch', '128', '--lr_warmup_steps', '40',
     '--loss_coef_conf_pos', '500'],
    ['--loss_coef_conf_neg', '0'],
    [],
    ['--recipe_batch', '128', '--max_steps', '375', '--lr_warmup_steps',
     '0'],
    ['--image_width', '320', '--image_height', '96', '--no_augmentation',
     '--decay_steps', '77', '--compute_dtype', 'bfloat16',
     '--image_cache_mb', '64'],
], ids=["base", "recipe", "recipe_overrides", "coef_zero", "defaults",
        "warmup_zero", "geometry"])
def test_config_from_args_equals_jax(argv):
    ours = port_cli.config_from_args(port_cli.build_arg_parser()
                                     .parse_args(argv))
    theirs = jax_cli.config_from_args(jax_cli.build_arg_parser()
                                      .parse_args(argv))
    assert _cfg_fields(ours) == _cfg_fields(theirs)


def test_recipe_batch_needs_max_steps():
    """The JAX CLI derives --recipe_batch's warmup from the 1,000,000-step
    default; the port refuses the flag without an explicit --max_steps."""
    p = port_cli.build_arg_parser()
    with pytest.raises(SystemExit, match="--max_steps"):
        port_cli.config_from_args(p.parse_args(['--recipe_batch', '128']))
    with pytest.raises(SystemExit):
        port_cli.config_from_args(p.parse_args(['--decay_steps', '0']))


@pytest.mark.parametrize("flag,match", [
    pytest.param(["--num_devices", "2", "--batch_size", "3"],
                 "not divisible", id="flag0-not divisible"),
    pytest.param(["--compilation_cache", "x"], "ROADMAP",
                 id="flag2-ROADMAP"),
    pytest.param(["--rng_impl", "rbg"], "ROADMAP", id="flag3-ROADMAP")])
def test_unported_flags_name_their_roadmap_item(flag, match, tmp_path):
    """Flags left out name their ROADMAP item; --num_devices is ported
    and refuses a batch that does not split over the ranks (its runs:
    test_torch_multiproc.py).  --steps_per_dispatch,
    --activation_summary and --native_loader are ported
    (test_torch_dispatch.py, test_torch_activation_summary.py,
    test_torch_native_loader.py)."""
    with pytest.raises(SystemExit, match=match):
        port_cli.main(["--device", "cpu", "--train_dir", str(tmp_path)]
                      + flag)


def test_step_tracer_writes_a_trace_of_its_steps(kitti_root, tmp_path):
    """--profile_steps' StepTracer traces steps [start, stop) through
    torch.profiler into a Chrome trace that holds the train step's ops."""
    import json

    from squeezedet_torch.utils.profiling import StepTracer
    logdir = str(tmp_path / "profile")
    _port_run(kitti_root, str(tmp_path / "p"), 3, device_augment=True,
              step_tracer=StepTracer(logdir, 1, 2))
    (name,) = os.listdir(logdir)
    assert name == "trace_steps_1_2.json"
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::conv") for e in events)
