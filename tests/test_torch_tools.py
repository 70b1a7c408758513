"""The port's host tools against the JAX package's: ``caffemodel2pkl``
on the V0/V1/V2 containers of ``tests/test_caffemodel.py``,
``random_split_train_val`` for one seed, ``squeezedet-torch-import``
into a port checkpoint, the orbax converter
(``tools/torch_from_jax_checkpoint.py``), and the launchers
(``scripts/torch_*.sh``) on the synthetic fixture."""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch.checkpoint.importer import load_pretrained
from squeezedet_torch.checkpoint.manager import CheckpointManager
from squeezedet_torch.optim import build_optimizer
from squeezedet_torch.tools import caffemodel2pkl, import_checkpoint
from squeezedet_torch.tools import random_split_train_val as split_tool
from squeezedet_torch.trainer import TrainState
from squeezedet_torch.weights import (checkpoint_to_jax_tree,
                                      pickle_from_jax_params, to_jax_params)
from squeezedet_tpu.checkpoint.importer import \
    load_pretrained as jax_load_pretrained
from squeezedet_tpu.tools import caffemodel2pkl as jax_caffemodel2pkl
from squeezedet_tpu.tools import random_split_train_val as jax_split_tool
from synth_kitti import make_synth_kitti
from test_caffemodel import (_blob_double, _blob_legacy, _blob_modern, _ld,
                             _net, _v0_connection, _v1_layer, _v2_layer,
                             _varint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_from_jax_checkpoint  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (autouse)


def _caffemodels():
    rs = np.random.RandomState(7)
    k = rs.randn(64, 3, 3, 3).astype(np.float32)
    b = rs.randn(64).astype(np.float32)
    return {
        "v2_packed_and_empty": _net([
            _v2_layer("conv1", [_blob_modern(k), _blob_modern(b)]),
            _v2_layer("relu_conv1", [])], field=100),
        "v1_unpacked": _net([_v1_layer(
            "fire2/squeeze1x1", [_blob_modern(k[:2, :, :1, :1],
                                              packed=False)])], field=2),
        "v0_nested": _net([_v0_connection(
            "conv_old", [_blob_legacy(k[:4, :2])])], field=2),
        "legacy_bias": _net([_v1_layer(
            "conv1", [_blob_legacy(b.reshape(1, 1, 1, 64))])], field=2),
        "double_data": _net([_v2_layer(
            "fc", [_blob_double(rs.randn(3, 5))])], field=100),
    }


@pytest.mark.parametrize("case", sorted(_caffemodels()))
def test_caffemodel_parse_matches_jax(case, tmp_path):
    path = tmp_path / "m.caffemodel"
    path.write_bytes(_caffemodels()[case])
    got = caffemodel2pkl.parse_caffemodel(str(path))
    want = jax_caffemodel2pkl.parse_caffemodel(str(path))
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_caffemodel_refusals_match_jax(tmp_path):
    bad = _ld(5, np.zeros(3, "<f4").tobytes()) + _ld(7, _ld(1, _varint(4)))
    for body, match in ((_net([_v2_layer("bad", [bad])], field=100),
                         "does not match"),
                        (_ld(1, b"name-only, no layers"), "no layers")):
        path = tmp_path / "bad.caffemodel"
        path.write_bytes(body)
        for tool in (caffemodel2pkl, jax_caffemodel2pkl):
            with pytest.raises(ValueError, match=match):
                tool.parse_caffemodel(str(path))
    with pytest.raises(SystemExit, match="squeezedet_torch.tools"):
        caffemodel2pkl.main(["one-arg"])


@pytest.mark.parametrize("joblib", [True, False])
def test_caffemodel_cli_to_importer(joblib, tmp_path, monkeypatch):
    """The CLI's pickle (joblib, or the standard pickle where joblib does
    not import) reads back through the port's and JAX's importers."""
    cm = tmp_path / "model.caffemodel"
    cm.write_bytes(_caffemodels()["v2_packed_and_empty"])
    if not joblib:
        monkeypatch.setitem(sys.modules, "joblib", None)
    out = tmp_path / "weights.pkl"
    caffemodel2pkl.main([str(tmp_path / "deploy.prototxt"), str(cm),
                         str(out)])
    got = load_pretrained(str(out))
    monkeypatch.undo()
    want = jax_load_pretrained(str(out))
    assert list(got) == list(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)


def test_split_matches_jax(tmp_path):
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        (d / "trainval.txt").write_text(
            "\n".join("{:06d}".format(i) for i in range(23)) + "\n")
    split_tool.main([str(tmp_path / "port"), "--seed", "3"])
    jax_split_tool.split(str(tmp_path / "jax"), seed=3)
    for name in ("train.txt", "val.txt"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert len((tmp_path / "port" / "train.txt").read_text().split()) == 11


def _seeded(net="squeezeDet", seed=3):
    return st.get_model(net, st.config_for_net(net).replace(
        load_pretrained_model=False), device="cpu",
        generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def weights_pickle(tmp_path_factory):
    """A caffe pickle of seeded squeezeDet weights, and the weights."""
    det = _seeded()
    path = str(tmp_path_factory.mktemp("pkl") / "weights.pkl")
    import pickle
    with open(path, "wb") as f:
        pickle.dump(pickle_from_jax_params(
            to_jax_params(det.backbone.state_dict())), f)
    return path, det.backbone.state_dict()


def test_import_writes_a_port_checkpoint(weights_pickle, tmp_path):
    """squeezedet-torch-import: the pickle's weights land in a port
    checkpoint that the eval and demo restore, bit for bit."""
    from squeezedet_torch.demo import load_params
    pkl, want = weights_pickle
    out = str(tmp_path / "ckpt")
    path = import_checkpoint.main(["--checkpoint", pkl, "--out_dir", out,
                                   "--step", "87000"])
    assert path.endswith("model.ckpt-87000")
    det = load_params(_seeded(seed=0), out)
    for key, value in want.items():
        assert torch.equal(det.backbone.state_dict()[key], value), key


def test_orbax_converter_round_trips_a_train_state(tmp_path):
    """A port train state written as a JAX orbax checkpoint (through
    weights.checkpoint_to_jax_tree) converts back to the same port
    checkpoint, momentum and step included."""
    import jax

    from squeezedet_tpu.checkpoint.manager import \
        CheckpointManager as JaxManager
    from squeezedet_tpu.config import config_for_net as jax_config
    from squeezedet_tpu.models import get_model as jax_model
    from squeezedet_tpu.optim import build_optimizer as jax_optimizer
    det = _seeded()
    opt = build_optimizer(det.cfg, det)
    g = torch.Generator().manual_seed(1)
    for t in opt.trace.values():
        t.copy_(torch.randn(t.shape, generator=g))
    opt.step = 7
    state = TrainState(det, opt)
    jdet = jax_model("squeezeDet", jax_config("squeezeDet"))
    params, mask, _ = jdet.init(jax.random.key(0))
    like = jax_optimizer(jdet.cfg, mask).init(params)
    JaxManager(str(tmp_path / "jax")).save(
        7, checkpoint_to_jax_tree(state.as_tree(), like))

    torch_from_jax_checkpoint.main(["--checkpoint_dir",
                                    str(tmp_path / "jax"), "--out_dir",
                                    str(tmp_path / "port")])
    fresh = TrainState(_seeded(seed=0), build_optimizer(det.cfg, det))
    step, tree = CheckpointManager(str(tmp_path / "port")).restore_latest(
        fresh.as_tree())
    assert step == 7 and tree["step"] == 7
    fresh.load_tree(tree)
    assert fresh.step == 7
    for key, value in det.backbone.state_dict().items():
        assert torch.equal(fresh.det.backbone.state_dict()[key], value), key
    for key, value in opt.trace.items():
        assert torch.equal(fresh.opt.trace[key], value), key


def test_launchers_refuse_unknown_flags():
    for script in ("torch_train.sh", "torch_eval.sh"):
        proc = subprocess.run(["bash", os.path.join(REPO, "scripts", script),
                               "-bogus", "x"], capture_output=True,
                              text=True, timeout=60)
        assert proc.returncode == 1 and "Usage" in proc.stdout


def test_parity_script_on_the_synthetic_fixture(weights_pickle, tmp_path):
    """scripts/torch_parity_vs_reference.sh end to end on the CPU: the
    pickle imported, the demo drawn, the val split scored."""
    root = str(tmp_path / "kitti")
    make_synth_kitti(root, num_images=3, width=320, height=96,
                     image_set="val")
    sample = os.path.join(root, "training", "image_2", "000000.png")
    env = dict(os.environ, DEVICE="cpu", SAMPLE=sample,
               WORK=str(tmp_path / "work"),
               EXTRA="--image_width 320 --image_height 96")
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "scripts",
                              "torch_parity_vs_reference.sh"), root,
         weights_pickle[0]], capture_output=True, text=True, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    mean_ap = float(re.search(r"measured mAP: (\S+)", proc.stdout).group(1))
    assert math.isfinite(mean_ap)
    assert os.path.isdir(str(tmp_path / "work" / "ckpt" /
                             "model.ckpt-87000"))
    assert os.path.exists(str(tmp_path / "work" / "demo" /
                              "out_000000.png"))
