"""Activation summaries in the port (``--activation_summary``) against the
JAX package on the CPU: ``Detector.activation_stats`` on the same weights
and images, and the tags the train CLI writes at its histogram steps.
"""

import jax
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import summary
from squeezedet_torch import train as port_cli
from squeezedet_torch.weights import from_jax_params
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.models import get_model as jax_get_model
from synth_kitti import make_synth_kitti

SAMPLE = 500  # small enough that most layers are sampled at a stride > 1
STATS = ("sparsity", "mean", "max", "min")


def _pair(net):
    """The JAX detector and params at the tiny config of ``net`` (random
    biases, so no layer is all zeros) and the port's detector on them."""
    jdet = jax_get_model(net, tiny_test_config(net))
    params, _, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: rng.randn(*p.shape).astype(np.float32) * 0.1
        if path[-1].key == "bias" else np.asarray(p), params)
    det = st.get_model(net, st.tiny_test_config(net), device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    return jdet, params, det


@pytest.mark.parametrize("net", ["squeezeDet", "resnet50"])
def test_activation_stats_match_jax(net):
    """Same layers (the tape and det_boxes/{cx,cy,w,h}), same sample
    stride and length, and each stat and sampled value within 1e-5
    relative, or 1e-5 of the layer's largest magnitude.  Sparsity is held
    to one element's share of the layer plus 1e-6: a pre-ReLU value
    within f32 rounding of zero falls on either side of it (one of
    resnet50's res4d elements does here)."""
    jdet, params, det = _pair(net)
    cfg = det.cfg
    images = np.random.RandomState(2).uniform(
        -100, 100, (2, cfg.image_height, cfg.image_width, 3)).astype(
            np.float32)
    want = jdet.activation_stats(params, images, sample=SAMPLE)
    got = det.activation_stats(torch.from_numpy(images), sample=SAMPLE)
    assert sorted(got) == sorted(want)  # a jitted dict comes back sorted
    assert "conv1" in got and "det_boxes/h" in got
    tape = {}
    with torch.no_grad():
        det.backbone(torch.from_numpy(images), tape=tape)
    sizes = {name: t.numel() for name, t in tape.items()}
    strided = 0
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w) == {"sample"} | set(STATS), name
        assert g["sample"].shape == np.asarray(w["sample"]).shape, name
        scale = max(abs(float(w["max"])), abs(float(w["min"])), 1e-30)
        for key in ("sample", "mean", "max", "min"):
            np.testing.assert_allclose(g[key], np.asarray(w[key]),
                                       rtol=1e-5, atol=1e-5 * scale,
                                       err_msg="{} {}".format(name, key))
        n = sizes.get(name, 2 * cfg.anchors)  # det_boxes: one per anchor
        assert abs(float(g["sparsity"]) - float(w["sparsity"])) <= \
            1.0 / n + 1e-6, name
        strided += g["sample"].size < SAMPLE * 2 - 1
    assert strided > len(want) // 2


class RecordingWriter:
    """A summary writer that keeps what it is given."""

    enabled = True

    def __init__(self, logdir):
        self.scalars, self.histograms = {}, {}
        RecordingWriter.last = self

    def scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))

    def histogram(self, tag, values, step, buckets=None):
        self.histograms.setdefault(tag, []).append((step, values))

    def image(self, tag, images, step, max_outputs=20):
        pass

    def close(self):
        pass


def test_cli_writes_activation_summaries(tmp_path, monkeypatch):
    """``--activation_summary`` at ``--histogram_step 1``: a histogram and
    four scalars per layer at each histogram step, the tags the JAX
    package's train test reads (tests/test_train.py)."""
    root = str(tmp_path / "kitti")
    make_synth_kitti(root, num_images=4, width=96, height=96)
    monkeypatch.setattr(summary, "SummaryWriter", RecordingWriter)
    state = port_cli.main([
        "--device", "cpu", "--data_path", root, "--train_dir",
        str(tmp_path / "train"), "--image_width", "96", "--image_height",
        "96", "--batch_size", "2", "--max_steps", "2", "--device_assign",
        "--uint8_ingest", "--device_augment", "--histogram_step", "1",
        "--summary_step", "1000", "--activation_summary"])
    assert state.step == 2
    writer = RecordingWriter.last
    act_tags = [t for t in writer.histograms if t.startswith("activations/")]
    assert "activations/conv1" in act_tags
    assert "activations/fire2" in act_tags
    assert "activations/det_boxes/cx" in act_tags
    for stat in STATS:
        assert "activation_summary/conv1/{}".format(stat) in writer.scalars
    s = writer.scalars["activation_summary/conv1/sparsity"][0][1]
    assert 0.0 <= s <= 1.0
    # one of each per histogram step, steps 0 and 1
    assert [step for step, _ in writer.histograms["activations/conv1"]] == \
        [0, 1]
    assert len(act_tags) * 4 == sum(
        t.startswith("activation_summary/") for t in writer.scalars)
