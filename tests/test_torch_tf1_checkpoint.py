"""The port's TF1 checkpoint reader (``checkpoint/importer.py``, numpy
only) against the JAX package's, which reads through TensorFlow: bundles
written by ``tf.compat.v1.train.Saver`` (as ``tests/test_importer.py``
writes them) give the same caffe-pickle dict bit for bit and the same
warnings, for squeezeDet's names, ResNet batch-norm groups, Momentum
and global_step slots and unmapped variables; every supported dtype
equals TensorFlow's own read; V1 and sliced checkpoints are refused."""

import os

import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch.checkpoint import importer
from squeezedet_torch.weights import to_jax_params
from squeezedet_tpu.checkpoint import importer as jax_importer
from torch_threads import one_thread  # noqa: F401  (autouse)

tf = pytest.importorskip("tensorflow")


def _save(path, variables, **saver_kw):
    """A TF1 Saver checkpoint of {name: initial value} at ``path``."""
    with tf.Graph().as_default(), tf.compat.v1.Session() as sess:
        for name, value in variables.items():
            tf.compat.v1.get_variable(name, initializer=value)
        sess.run(tf.compat.v1.global_variables_initializer())
        tf.compat.v1.train.Saver(**saver_kw).save(sess, path)
    return path


def _assert_same_dicts(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for g, w in zip(got[name], want[name]):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_squeezedet_checkpoint_matches_jax_and_loads(tmp_path):
    """Every squeezeDet layer with its Momentum slot and global_step: the
    port's dict equals JAX's, and the detector built from it holds the
    saved weights."""
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu",
                       generator=torch.Generator().manual_seed(7))
    variables = {"global_step": np.int64(300)}

    def add(scope, leaves):
        for leaf, tf_leaf in (("kernel", "kernels"), ("bias", "biases")):
            variables["{}/{}".format(scope, tf_leaf)] = leaves[leaf]
            variables["{}/{}/Momentum".format(scope, tf_leaf)] = \
                np.zeros_like(leaves[leaf])

    for name, node in to_jax_params(det.backbone.state_dict()).items():
        if "kernel" in node:
            add(name, node)
        else:
            for sub, leaves in node.items():
                add(name + "/" + sub, leaves)
    ckpt = _save(str(tmp_path / "model.ckpt-300"), variables)

    got = importer.load_pretrained(ckpt)
    _assert_same_dicts(got, jax_importer.load_pretrained(ckpt))
    fresh = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    fresh.load_pretrained(got)
    for key, value in det.backbone.state_dict().items():
        assert torch.equal(fresh.backbone.state_dict()[key], value), key


def test_resnet_bn_groups_and_warnings_match_jax(tmp_path, capsys):
    rs = np.random.RandomState(3)

    def r(*shape):
        return rs.randn(*shape).astype(np.float32)

    variables = {"conv1/kernels": r(7, 7, 3, 8),
                 "conv1/biases": r(8)}
    for scope, c in (("conv1", 8), ("res2a_branch1", 16),
                     ("res2a_branch2a", 4)):
        if scope != "conv1":
            variables[scope + "/kernels"] = r(1, 1, 8, c)
        for leaf in ("gamma", "beta", "mean", "var"):
            variables["{}/{}".format(scope, leaf)] = r(c)
    variables.update({"bnonly/gamma": r(8),           # incomplete group
                      "conv9/weird_weight": r(4),     # outside the contract
                      "res2a_branch1/kernels/Momentum": r(1, 1, 8, 16),
                      "iou": r(2)})
    ckpt = _save(str(tmp_path / "model.ckpt-1"), variables)
    capsys.readouterr()
    got = importer.load_tf1_checkpoint(ckpt)
    port_out = capsys.readouterr().out
    want = jax_importer.load_tf1_checkpoint(ckpt)
    jax_out = capsys.readouterr().out
    _assert_same_dicts(got, want)
    assert {"bn_conv1", "scale_conv1", "bn2a_branch1", "scale2a_branch1",
            "bn2a_branch2a", "scale2a_branch2a"} <= set(got)
    assert "bnonly" not in got and "conv9" not in got
    assert sorted(port_out.splitlines()) == sorted(jax_out.splitlines())
    assert "conv9/weird_weight" in port_out and "'bnonly'" in port_out


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "float16", "bfloat16"])
def test_every_dtype_equals_tensorflow(dtype, tmp_path):
    rs = np.random.RandomState(1)
    value = (rs.randn(3, 5) * 100).astype(
        np.float32 if dtype == "bfloat16" else dtype)
    if dtype == "bfloat16":
        value = tf.cast(value, tf.bfloat16).numpy()
    ckpt = _save(str(tmp_path / "model.ckpt-2"), {"t": value})
    got = importer.read_tf_bundle(ckpt)["t"]
    want = tf.train.load_checkpoint(ckpt).get_tensor("t")
    if dtype == "bfloat16":  # widened exactly to float32
        assert got.dtype == np.float32
        want = want.astype(np.float32)
    assert got.dtype == want.dtype and got.shape == (3, 5)
    np.testing.assert_array_equal(got, want)


def test_v1_sliced_and_corrupt_checkpoints_are_refused(tmp_path):
    w = np.ones((4, 2), np.float32)
    (tmp_path / "v1").mkdir()
    v1 = _save(str(tmp_path / "v1" / "model.ckpt-3"), {"conv1/biases": w[0]},
               write_version=tf.compat.v1.train.SaverDef.V1)
    assert os.path.isfile(v1) and not os.path.exists(v1 + ".index")
    with pytest.raises(ValueError, match="V1 checkpoint"):
        importer.load_pretrained(v1)

    sliced = str(tmp_path / "sliced" / "model.ckpt-4")
    with tf.Graph().as_default(), tf.compat.v1.Session() as sess:
        tf.compat.v1.get_variable(
            "conv1/kernels", shape=(4, 4),
            initializer=tf.compat.v1.ones_initializer(),
            partitioner=tf.compat.v1.fixed_size_partitioner(2))
        sess.run(tf.compat.v1.global_variables_initializer())
        tf.compat.v1.train.Saver().save(sess, sliced)
    with pytest.raises(ValueError, match="slices"):
        importer.load_tf1_checkpoint(sliced)

    ckpt = _save(str(tmp_path / "model.ckpt-5"), {"conv1/biases": w[0]})
    with open(ckpt + ".index", "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\0")  # break the table magic
    with pytest.raises(ValueError, match="table magic"):
        importer.read_tf_bundle(ckpt)
    with pytest.raises(FileNotFoundError):
        importer.read_tf_bundle(str(tmp_path / "model.ckpt-6"))
