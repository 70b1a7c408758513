"""The train, eval, serve and demo entry points of the port on the
squeezeDet+, VGG16 and ResNet50 backbones, on the CPU at 160x96.

The train CLI trains each net from its seeded init and resumes; the eval
CLI scores the same weights as the JAX package's eval CLI (JAX params
with perturbed biases and batch-norm terms and a head scaled to O(1)
preds, so scores are spread out: equal APs within 1e-3 and equal
detection lines per file); the server serves a checkpoint of each net;
the demo runs squeezeDet+, as the JAX demo does, and refuses the others.
"""

import functools
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import demo, serve
from squeezedet_torch import eval as port_eval
from squeezedet_torch import train as port_cli
from squeezedet_torch.checkpoint.manager import CheckpointManager
from squeezedet_torch.config import config_for_net_at
from squeezedet_torch.weights import (from_jax_params,
                                      pickle_from_jax_params)
from squeezedet_tpu import eval as jax_eval
from squeezedet_tpu.config.kitti import \
    config_for_net_at as jax_config_for_net_at
from squeezedet_tpu.models import get_model as jax_get_model
from synth_kitti import make_synth_kitti

NETS = ["squeezeDet+", "vgg16", "resnet50"]
HEADS = {"squeezeDet+": "conv12", "vgg16": "conv6", "resnet50": "conv5"}
W, H = 160, 96
SIZE = ["--image_width", str(W), "--image_height", str(H)]
BOX_RTOL, BOX_ATOL, PROB_RTOL = 1e-4, 1e-3, 1e-5


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_backbones"))
    make_synth_kitti(root, num_images=6, width=W, height=H, image_set="val")
    return root


@functools.lru_cache(maxsize=None)
def _params(net):
    """JAX params at W x H: biases N(0, 0.1), batch-norm mean N(0, 0.2),
    var U(0.3, 3), gamma U(0.5, 1.5), beta N(0, 0.1), and an N(0, 1) head
    scaled so that the preds have std 1; as numpy."""
    jdet = jax_get_model(net, jax_config_for_net_at(net, W, H))
    tree, _, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)
    draw = {"bias": lambda s: rng.randn(*s) * 0.1,
            "mean": lambda s: rng.randn(*s) * 0.2,
            "var": lambda s: rng.uniform(0.3, 3.0, s),
            "gamma": lambda s: rng.uniform(0.5, 1.5, s),
            "beta": lambda s: rng.randn(*s) * 0.1}

    def perturb(path, p):
        name = path[-1].key
        if path[0].key == HEADS[net] and name == "kernel":
            return rng.randn(*p.shape).astype(np.float32)
        if name in draw:
            return draw[name](p.shape).astype(np.float32)
        return np.asarray(p)
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    x = np.random.RandomState(9).randn(2, H, W, 3).astype(np.float32) * 60
    spread = np.float32(np.std(np.asarray(jdet.forward(tree,
                                                       jnp.asarray(x)))))
    tree[HEADS[net]] = {k: v / spread for k, v in tree[HEADS[net]].items()}
    return tree


def _read_aps(eval_dir, step):
    out = {}
    data = os.path.join(eval_dir, "detection_files_{}".format(step))
    for name in sorted(os.listdir(data)):
        if name.startswith("stats_") and name.endswith("_ap.txt"):
            with open(os.path.join(data, name)) as f:
                out[name] = [float(line.split("=")[1]) for line in f]
    return out


def _line_counts(eval_dir, step):
    data = os.path.join(eval_dir, "detection_files_{}".format(step), "data")
    counts = {}
    for name in sorted(os.listdir(data)):
        with open(os.path.join(data, name)) as f:
            counts[name] = len(f.read().splitlines())
    return counts


@pytest.mark.parametrize("net", NETS)
def test_train_cli_trains_checkpoints_and_resumes(net, kitti_root,
                                                  tmp_path, capsys):
    """``squeezedet_torch.train --net <net> --device cpu`` on the canvas
    feed: finite logged losses, checkpoints at steps 0 and 2 holding every
    state_dict entry (the batch-norm statistics too), the net's layers in
    model_metrics.txt; frozen leaves and the statistics stay at their
    seeded init; a second call resumes after step 2's checkpoint (the
    state of 3 updates)."""
    train_dir = str(tmp_path / "train")
    argv = ["--net", net, "--device", "cpu", "--data_path", kitti_root,
            "--image_set", "val", "--train_dir", train_dir] + SIZE + [
            "--batch_size", "2", "--checkpoint_step", "2", "--device_assign",
            "--uint8_ingest", "--device_augment", "--learning_rate", "0.001",
            "--summary_step", "0"]
    state = port_cli.main(argv + ["--max_steps", "3"])
    out = capsys.readouterr().out
    assert state.step == 3 and state.det.net == net
    losses = [float(v) for v in re.findall(r"loss = (\S+) \(", out)]
    assert losses and np.isfinite(losses).all()
    names = sorted(os.listdir(train_dir))
    assert [n for n in names if n.startswith("model.ckpt")] == \
        ["model.ckpt-0", "model.ckpt-2"]
    saved = CheckpointManager(train_dir).restore_params(
        2, state.det.backbone.state_dict())
    seeded = st.get_model(net, state.det.cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    mask = seeded.trainable_mask()
    assert set(saved) == set(mask)
    for name, value in seeded.backbone.state_dict().items():
        if not mask[name]:
            assert torch.equal(saved[name], value), name
    with open(os.path.join(train_dir, "model_metrics.txt")) as f:
        metrics = f.read()
    assert "conv1" in metrics and HEADS[net] in metrics
    state = port_cli.main(argv + ["--max_steps", "4"])
    assert state.step == 4 and "Resumed from step 3" in \
        capsys.readouterr().out


@pytest.mark.parametrize("net", NETS)
def test_eval_cli_matches_jax(net, kitti_root, tmp_path, capsys):
    """``eval --net <net> --run_once`` of both packages on the same
    weights (the JAX CLI from an orbax checkpoint, the port's from a port
    checkpoint): every image scored, the same APs within 1e-3 and the
    same detection lines per file."""
    from squeezedet_tpu.checkpoint.manager import \
        CheckpointManager as JaxCheckpointManager
    params = _params(net)
    JaxCheckpointManager(str(tmp_path / "jax_ckpt")).save(
        5, {"params": params})
    CheckpointManager(str(tmp_path / "port_ckpt")).save(
        5, {"params": from_jax_params(params)})
    common = ["--net", net, "--data_path", kitti_root, "--image_set", "val",
              "--run_once", "--eval_batch_size", "2"] + SIZE
    jax_eval.main(common + ["--checkpoint_path", str(tmp_path / "jax_ckpt"),
                            "--eval_dir", str(tmp_path / "jax_eval")])
    port_eval.main(common + ["--device", "cpu", "--checkpoint_path",
                             str(tmp_path / "port_ckpt"), "--eval_dir",
                             str(tmp_path / "port_eval")])
    assert "Evaluating step 5" in capsys.readouterr().out
    want, got = (_read_aps(str(tmp_path / "jax_eval"), 5),
                 _read_aps(str(tmp_path / "port_eval"), 5))
    assert sorted(got) == sorted(want) and got
    for cls in want:
        assert np.isfinite(got[cls]).all()
        np.testing.assert_allclose(got[cls], want[cls], atol=1e-3)
    counts = _line_counts(str(tmp_path / "port_eval"), 5)
    assert len(counts) == 6 and sum(counts.values()) > 0
    assert counts == _line_counts(str(tmp_path / "jax_eval"), 5)


@pytest.mark.parametrize("net", NETS)
def test_serves_a_checkpoint_of_each_net(net, tmp_path):
    """``serve --net <net> --checkpoint <pickle>``: the server's program
    returns what ``predict_raw_postprocessed`` gives with those weights
    (ResNet's pickle carries its batch-norm entries)."""
    params = _params(net)
    path = str(tmp_path / "weights.pkl")
    with open(path, "wb") as f:
        pickle.dump(pickle_from_jax_params(params), f)
    cfg = config_for_net_at(net, W, H)
    args = serve.build_arg_parser().parse_args(
        ["--net", net, "--device", "cpu", "--compute_dtype", "float32",
         "--max_batch", "2", "--checkpoint", path])
    run, meta = serve._build_from_checkpoint(args, cfg)
    assert (meta["image_height"], meta["image_width"]) == (H, W)
    det = st.get_model(net, cfg.replace(batch_size=2), device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    u8 = np.random.RandomState(3).randint(0, 256, (2, H, W, 3), np.uint8)
    got = run(u8)
    want = det.predict_raw_postprocessed(torch.from_numpy(u8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert 0 < got[3].sum() < got[3].size


def test_demo_runs_squeezedet_plus(kitti_root, tmp_path, capsys):
    """``demo --demo_net squeezeDet+`` draws every input frame from a
    port checkpoint, and the lists it draws equal the JAX demo's on the
    same weights and frame."""
    import cv2

    from squeezedet_tpu import demo as jax_demo
    params = _params("squeezeDet+")
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(1, {"params": from_jax_params(params)})
    frames = os.path.join(kitti_root, "training", "image_2", "00000[0-1].png")
    out_dir = str(tmp_path / "out")
    demo.main(["--demo_net", "squeezeDet+", "--device", "cpu",
               "--checkpoint", ckpt, "--input_path", frames, "--out_dir",
               out_dir] + SIZE)
    assert "Restored step 1" in capsys.readouterr().out
    outs = sorted(os.listdir(out_dir))
    assert outs == ["out_000000.png", "out_000001.png"]
    assert cv2.imread(os.path.join(out_dir, outs[0])).shape == (H, W, 3)

    jcfg = jax_config_for_net_at("squeezeDet+", W, H).replace(
        batch_size=1, plot_prob_thresh=0.01)
    jdet = jax_get_model("squeezeDet+", jcfg)
    cfg = config_for_net_at("squeezeDet+", W, H).replace(
        batch_size=1, plot_prob_thresh=0.01)
    det = st.get_model("squeezeDet+", cfg, device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    im = np.random.RandomState(1).randn(H, W, 3).astype(np.float32) * 40
    for device_pp in (False, True):
        if device_pp:
            out = jdet.postprocess_device(jdet.predict(
                params, jnp.asarray(im[None])))
        else:
            out = jdet.predict(params, jnp.asarray(im[None]))
        want = jax_demo._filter_outputs(jdet, out, jcfg, device_pp)
        got = demo._filter_outputs(det, demo._predict(det, im, device_pp),
                                   cfg, device_pp)
        assert len(want[0]) > 0
        assert list(got[2]) == list(want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=PROB_RTOL)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   rtol=BOX_RTOL, atol=BOX_ATOL)
