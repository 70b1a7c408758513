"""The port's exported artifact (``squeezedet_torch/serving.py``,
``export.py``) and its int8 entry points against the JAX package's on
the CPU: export round trips (f32 uint8 -> detections, the raw
interpretation of float input, int8), the artifact's metadata, K1 as a
registered op inside the artifact, device refusals, and the CLIs that
take an artifact or quantize (export, serve, eval, demo).

Weights come from the JAX package's init with random biases and a wider
head, so top-K ranks and NMS choices are not near-ties.  An artifact
reloads to outputs equal to the port's direct program, bit for bit (the
same aten ops run); against the JAX package's artifact on the same
weights, f32 boxes and probs agree within 1e-5 (f32 sums in other
orders) and int8 ones within 1e-6, with equal classes and keep.
"""

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import demo, serve
from squeezedet_torch import eval as port_eval
from squeezedet_torch import export as port_export
from squeezedet_torch.checkpoint.manager import CheckpointManager
from squeezedet_torch.config import config_for_net_at
from squeezedet_torch.serving import export_model, load_exported
from squeezedet_torch.weights import from_jax_params, from_jax_qparams
from squeezedet_tpu import serving as jax_serving
from squeezedet_tpu.config import tiny_test_config as jax_tiny_config
from squeezedet_tpu.models import get_model as jax_get_model

S = 96  # tiny geometry, S x S
F32_TOL, INT8_TOL = 1e-5, 1e-6
META_KEYS = {"net", "class_names", "image_height", "image_width",
             "batch_size", "input_dtype", "input_is_bgr_raw", "quantized",
             "bgr_means", "postprocess", "outputs", "plot_prob_thresh",
             "platforms"}


@pytest.fixture(scope="module")
def params():
    """JAX params with random biases and a wider head, as numpy."""
    jdet = jax_get_model("squeezeDet", jax_tiny_config())
    tree, _, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)

    def perturb(path, p):
        if path[-1].key == "bias":
            return rng.randn(*p.shape).astype(np.float32) * 0.1
        if path[0].key == "conv12":
            return rng.randn(*p.shape).astype(np.float32) * 0.05
        return np.asarray(p)
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _models(params, batch):
    jdet = jax_get_model("squeezeDet", jax_tiny_config(batch_size=batch))
    det = st.get_model("squeezeDet", st.tiny_test_config(batch_size=batch)
                       .replace(compute_dtype="float32"), device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    return jdet, det


def _u8(b, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (b, S, S, 3),
                                               np.uint8)


def _assert_close(got, want, tol):
    """Postprocessed or raw outputs: floats within ``tol``, the integer
    and boolean ones equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(g, w)


def test_export_roundtrip_matches_direct_and_jax(params, tmp_path):
    """uint8 -> postprocessed detections at B=1: the reloaded artifact
    equals the direct program bit for bit and JAX's artifact within
    F32_TOL; the metadata has JAX's keys, ``platforms`` the traced
    device."""
    jdet, det = _models(params, 1)
    export_model(det, str(tmp_path / "port"), batch_size=1)
    fn, meta = load_exported(str(tmp_path / "port"))
    jax_serving.export_model(jdet, params, str(tmp_path / "jax"),
                             batch_size=1, platforms=("cpu",))
    jfn, jmeta = jax_serving.load_exported(str(tmp_path / "jax"))
    assert set(meta) == set(jmeta) == META_KEYS
    for k in META_KEYS - {"platforms"}:
        assert meta[k] == jmeta[k], k
    assert meta["platforms"] == ["cpu"] and meta["quantized"] is False
    u8 = _u8(1)
    got = fn(u8)
    direct = det.predict_raw_postprocessed(torch.from_numpy(u8))
    for g, d in zip(got, direct):
        assert torch.equal(g, d)
    _assert_close(got, jfn(u8), F32_TOL)
    assert got[3].any()


def test_export_raw_interpretation_f32(params, tmp_path):
    """Mean-subtracted f32 input, no postprocess, B=2."""
    jdet, det = _models(params, 2)
    export_model(det, str(tmp_path / "raw"), batch_size=2,
                 uint8_input=False, postprocess=False)
    fn, meta = load_exported(str(tmp_path / "raw"))
    assert meta["postprocess"] is False and meta["input_dtype"] == "float32"
    im = np.random.RandomState(1).randn(2, S, S, 3).astype(np.float32)
    got = fn(im)
    interp = det.predict(torch.from_numpy(im))
    for g, d in zip(got, (interp.det_boxes, interp.det_probs,
                          interp.det_class)):
        assert torch.equal(g, d)
    jax_serving.export_model(jdet, params, str(tmp_path / "jax"),
                             batch_size=2, uint8_input=False,
                             postprocess=False, platforms=("cpu",))
    jfn, _ = jax_serving.load_exported(str(tmp_path / "jax"))
    _assert_close(got, jfn(im), F32_TOL)


@pytest.mark.parametrize("start", ["", "fire4"])
def test_export_quantized_roundtrip(params, tmp_path, start):
    """An int8 artifact of JAX's own int8 tree (``from_jax_qparams``):
    equal to the direct int8 program bit for bit, and to JAX's int8
    artifact within INT8_TOL (whole-net) or F32_TOL (from fire4, with
    float layers before)."""
    from squeezedet_tpu import quant as JQ
    jdet, det = _models(params, 1)
    calib = _u8(2, seed=3)
    qp = jax.tree.map(np.asarray, JQ.quantize(jdet, params, [calib],
                                              start=start))
    qdet = from_jax_qparams(det, qp)
    export_model(qdet, str(tmp_path / "q"), batch_size=1)
    fn, meta = load_exported(str(tmp_path / "q"))
    assert meta["quantized"] is True
    u8 = _u8(1, seed=4)
    got = fn(u8)
    for g, d in zip(got, qdet.predict_quant_postprocessed(
            torch.from_numpy(u8))):
        assert torch.equal(g, d)
    jax_serving.export_model(jdet, qp, str(tmp_path / "jax"), batch_size=1,
                             platforms=("cpu",), quantized=True)
    jfn, _ = jax_serving.load_exported(str(tmp_path / "jax"))
    # behind a hybrid boundary the float layers' f32 rounding reaches the
    # boxes too
    _assert_close(got, jfn(u8), F32_TOL if start else INT8_TOL)


def _k1_nodes(path):
    program = torch.export.load(os.path.join(path, "model.pt2"))
    return [n for n in program.graph.nodes
            if "squeezedet_torch.conv1_pool1" in str(n.target)]


def test_artifact_calls_k1_as_a_registered_op(params, tmp_path):
    """The float artifact and a hybrid int8 one (start after conv1) call
    K1 as ``squeezedet_torch::conv1_pool1``, once; the whole-net int8
    artifact does not (its conv1 is an int8 GEMM and pool)."""
    _, det = _models(params, 1)
    calib = [_u8(2)]
    for name, model, k1 in [("f32", det, 1),
                            ("hybrid", det.quantize(calib, start="fire2"),
                             1),
                            ("whole", det.quantize(calib), 0)]:
        export_model(model, str(tmp_path / name), batch_size=1)
        assert len(_k1_nodes(str(tmp_path / name))) == k1, name


def test_load_exported_refuses_another_device(params, tmp_path):
    _, det = _models(params, 1)
    path = str(tmp_path / "a")
    export_model(det, path, batch_size=1)
    with pytest.raises(ValueError, match="traced on cpu"):
        load_exported(path, device="meta")
    meta_file = os.path.join(path, "metadata.json")
    meta = json.load(open(meta_file))
    meta["platforms"] = ["cuda"]
    json.dump(meta, open(meta_file, "w"))
    with pytest.raises(ValueError, match="traced on cuda"):
        load_exported(path, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(path)


def _frames(dirname, n=3, seed=5):
    os.makedirs(dirname, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        cv2.imwrite(os.path.join(dirname, "f{}.png".format(i)),
                    rng.randint(0, 256, (S, S, 3)).astype(np.uint8))
    return dirname


def _checkpoint(params, path):
    CheckpointManager(path).save(3, {"params": from_jax_params(params)})
    return path


@pytest.mark.parametrize("extra,quantized", [([], False),
                                             (["--quantize", "int8"], True)])
def test_export_cli(params, tmp_path, extra, quantized):
    """``squeezedet-torch-export`` from a port checkpoint, float and int8:
    the artifact equals the program built from the same checkpoint (and,
    for int8, the same calibration frames)."""
    from squeezedet_torch.quant import calib_batch_from_images
    ckpt = _checkpoint(params, str(tmp_path / "ckpt"))
    calib = _frames(str(tmp_path / "calib"))
    out = str(tmp_path / "art")
    argv = ["--device", "cpu", "--checkpoint", ckpt, "--out_dir", out,
            "--image_width", str(S), "--image_height", str(S),
            "--batch_size", "2", "--compute_dtype", "float32"]
    if quantized:
        argv += ["--calib_images", calib]
    port_export.main(argv + extra)
    fn, meta = load_exported(out)
    assert meta["quantized"] is quantized and meta["batch_size"] == 2
    det = st.get_model("squeezeDet", config_for_net_at(
        "squeezeDet", S, S).replace(batch_size=2, compute_dtype="float32"),
        device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    u8 = torch.from_numpy(_u8(2, seed=6))
    if quantized:
        qdet = det.quantize([calib_batch_from_images(calib, S, S)])
        want = qdet.predict_quant_postprocessed(u8)
    else:
        want = det.predict_raw_postprocessed(u8)
    for g, w in zip(fn(u8), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("flags,match", [
    (["--quantize", "int8"], "needs --calib_images"),
    (["--platforms", "tpu,cpu"], "traced on one device"),
    (["--device", "cuda"], "no CUDA device")])
def test_export_cli_refusals(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        port_export.main(["--device", "cpu", "--out_dir",
                          str(tmp_path / "a")] + flags)


def test_serve_artifact_answers_concurrent_requests(params, tmp_path):
    """``serve --artifact`` at ``--max_batch 2``: the micro-batched server
    runs the artifact, and each request gets the artifact's row for its
    frame."""
    _, det = _models(params, 2)
    path = str(tmp_path / "art")
    export_model(det, path, batch_size=2)
    args = serve.build_arg_parser().parse_args(
        ["--device", "cpu", "--artifact", path, "--max_batch", "2",
         "--port", "0"])
    server, batcher = serve.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        frames = _u8(4, seed=7)
        with ThreadPoolExecutor(4) as pool:
            replies = list(pool.map(batcher.submit, frames))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert batcher.requests == 4 and 2 <= batcher.batches_run <= 4
    for frame, reply in zip(frames, replies):
        want = det.predict_raw_postprocessed(torch.from_numpy(
            np.stack([frame, frame])))
        for g, w in zip(reply, want):
            np.testing.assert_array_equal(g[0], w[0].numpy())


@pytest.mark.parametrize("export_kw,flags,match", [
    (dict(postprocess=False), [], "--no_postprocess"),
    (dict(uint8_input=False), [], "float32 input"),
    ({}, ["--max_batch", "2"], "batch_size=1"),
    ({}, ["--quantize", "int8"], "does not apply to --artifact"),
    ({}, ["--num_devices", "2", "--max_batch", "2"], "needs --checkpoint")])
def test_serve_artifact_refusals(params, tmp_path, export_kw, flags, match):
    _, det = _models(params, 1)
    path = str(tmp_path / "art")
    export_model(det, path, batch_size=1, **export_kw)
    args = serve.build_arg_parser().parse_args(
        ["--device", "cpu", "--artifact", path] + flags)
    with pytest.raises(SystemExit, match=match):
        serve.build_server(args)


def test_serve_quantize(params, tmp_path):
    """``serve --quantize int8 --calib_images``: the server's program is
    the int8 one of its weights, calibrated on those frames; without
    --calib_images it refuses."""
    from squeezedet_torch.quant import calib_batch_from_images
    ckpt = _checkpoint(params, str(tmp_path / "ckpt"))
    calib = _frames(str(tmp_path / "calib"))
    cfg = st.tiny_test_config()
    args = serve.build_arg_parser().parse_args(
        ["--device", "cpu", "--checkpoint", ckpt, "--compute_dtype",
         "float32", "--max_batch", "2", "--quantize", "int8",
         "--calib_images", calib])
    run, _ = serve._build_from_checkpoint(args, cfg)
    _, det = _models(params, 2)
    qdet = det.quantize([calib_batch_from_images(calib, S, S)])
    u8 = _u8(2, seed=8)
    for g, w in zip(run(u8), qdet.predict_quant_postprocessed(
            torch.from_numpy(u8))):
        np.testing.assert_array_equal(g, w.numpy())
    args.calib_images = ""
    with pytest.raises(SystemExit, match="needs --calib_images"):
        serve._build_from_checkpoint(args, cfg)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    from synth_kitti import make_synth_kitti
    root = str(tmp_path_factory.mktemp("kitti_int8"))
    make_synth_kitti(root, num_images=8, width=320, height=96,
                     image_set="val")
    return root


def _read_aps(eval_dir, step):
    """{class: APs} of the stats files the scorer wrote for ``step``."""
    out = {}
    result_dir = os.path.join(eval_dir, "detection_files_{}".format(step))
    for cls in ("car", "pedestrian", "cyclist"):
        path = os.path.join(result_dir, "stats_{}_ap.txt".format(cls))
        if os.path.exists(path):
            out[cls] = [float(line.split("=")[1]) for line in open(path)]
    return out


def test_eval_quantize_matches_jax(params, kitti_root, tmp_path, capsys):
    """``eval --quantize int8 --run_once``.  ``quantize_on_split``
    calibrates on the split's first batches, read as the JAX eval reads
    them, to scales within 1e-5 of JAX's; on JAX's own int8 tree the
    port's int8 detections equal the JAX eval's within the eval tests'
    tolerance (rtol 1e-4, atol 1e-3), per class and image; and the CLI
    scores the split with finite APs."""
    from squeezedet_torch.data.kitti import Kitti
    from squeezedet_torch.quant import calibrate_normalized, \
        quantize_detector
    from squeezedet_tpu import eval as jax_eval
    from squeezedet_tpu import quant as JQ
    from squeezedet_tpu.data import Kitti as JaxKitti
    jcfg = jax_tiny_config(image_width=320, image_height=96, batch_size=4)
    jdet = jax_get_model("squeezeDet", jcfg)
    det = st.get_model("squeezeDet", st.tiny_test_config(
        image_width=320, image_height=96, batch_size=4), device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    jdb, db = JaxKitti("val", kitti_root, jcfg), Kitti("val", kitti_root,
                                                       det.cfg)
    batches = [np.stack(db.read_image_batch(shuffle=False)[0])
               for _ in range(2)]
    scales = calibrate_normalized(det, batches)
    want_scales = JQ.calibrate_normalized(jdet, params, batches)
    assert sorted(scales) == sorted(want_scales)
    for k, v in want_scales.items():
        assert scales[k] == pytest.approx(v, rel=1e-5), k
    qdet = port_eval.quantize_on_split(det, db, 2)
    assert qdet.quantized and not det.quantized
    direct = quantize_detector(det, scales)
    for k, v in direct.state_dict().items():
        assert torch.equal(qdet.state_dict()[k], v), k

    qp = jax.tree.map(np.asarray, jax_eval.quantize_on_split(
        jdet, jdb, params, 2))
    want, want_n, _ = jax_eval.detect_all(jdet, jdb, qp, 4, quant=True,
                                          device_postprocess=True)
    got, got_n, _ = port_eval.detect_all(from_jax_qparams(det, qp), db, 4,
                                         device_postprocess=True)
    assert got_n == want_n > 0
    for c in range(len(want)):
        for i in range(8):
            a = np.asarray(sorted(map(tuple, want[c][i])))
            b = np.asarray(sorted(map(tuple, got[c][i])))
            assert a.shape == b.shape, (c, i)
            if a.size:
                np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3)

    ckpt = _checkpoint(params, str(tmp_path / "ckpt"))
    port_eval.main(["--device", "cpu", "--data_path", kitti_root,
                    "--image_set", "val", "--run_once", "--image_width",
                    "320", "--image_height", "96", "--eval_batch_size", "4",
                    "--checkpoint_path", ckpt, "--eval_dir",
                    str(tmp_path / "ev"), "--quantize", "int8",
                    "--calib_batches", "2", "--skip_analysis"])
    out = capsys.readouterr().out
    assert "Quantizing (int8 PTQ, 2 calibration batches)" in out
    assert "Mean average precision" in out
    aps = _read_aps(str(tmp_path / "ev"), 3)
    assert aps and all(np.isfinite(v).all() for v in aps.values())


def test_demo_quantize(params, tmp_path, capsys, monkeypatch):
    """``demo --quantize int8`` in image mode calibrates on the input
    frames and runs the int8 program: each frame's raw outputs equal those
    of the int8 detector built from the same frames.  In video mode it
    needs --calib_images."""
    from squeezedet_torch.quant import calib_batch_from_images
    frames = _frames(str(tmp_path / "in"), n=2, seed=9)
    ckpt = _checkpoint(params, str(tmp_path / "ckpt"))
    out = str(tmp_path / "out")
    drawn = []
    real = demo._filter_outputs

    def spy(det, o, mc, device_pp):
        assert det.quantized
        drawn.append(o)
        return real(det, o, mc, device_pp)
    monkeypatch.setattr(demo, "_filter_outputs", spy)
    demo.main(["--device", "cpu", "--image_width", str(S),
               "--image_height", str(S), "--checkpoint", ckpt,
               "--out_dir", out, "--compute_dtype", "float32",
               "--input_path", os.path.join(frames, "*.png"),
               "--quantize", "int8"])
    assert sorted(os.listdir(out)) == ["out_f0.png", "out_f1.png"]
    assert "Quantizing (int8 PTQ, 2 calibration frames)" in \
        capsys.readouterr().out
    det = st.get_model("squeezeDet", config_for_net_at(
        "squeezeDet", S, S).replace(batch_size=1, compute_dtype="float32"),
        device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    qdet = det.quantize([calib_batch_from_images(
        os.path.join(frames, "*.png"), S, S)])
    assert len(drawn) == 2
    for name in ("f0.png", "f1.png"):
        im = cv2.resize(cv2.imread(os.path.join(frames, name)).astype(
            np.float32), (S, S)) - det.cfg.bgr_means_array()
        want = demo._predict(qdet, im, False)
        assert sum(all(np.array_equal(g, w) for g, w in zip(o, want))
                   for o in drawn) == 1, name
    with pytest.raises(SystemExit, match="needs --calib_images"):
        demo.main(["--device", "cpu", "--mode", "video", "--checkpoint",
                   "", "--out_dir", out, "--quantize", "int8",
                   "--input_path", "x.avi"])
