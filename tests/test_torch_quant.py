"""int8 post-training quantization of the port (``squeezedet_torch/
quant.py``, the int8 layer ops, the activation tape) against the JAX
package's on the CPU.

Inputs come from numpy seeds; weights from the JAX package's init at a
tiny geometry, crossing with ``weights.from_jax_params``.  The int8
arithmetic is exact in both packages (integer accumulation, a multiply
then an add then round in f32), so int8 activations are held equal,
allowing at most 1 apart on at most 1e-4 of the elements in case XLA
contracts the epilogue's multiply-add into one rounding; f32 values that
come out of the same integers are held to 1e-6 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import quant as TQ
from squeezedet_torch.models import layers as TL
from squeezedet_torch.ops import fused_frontend as ff
from squeezedet_torch.weights import from_jax_params, from_jax_qparams
from squeezedet_tpu import quant as JQ
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.data.device_pipeline import normalize_images
from squeezedet_tpu.models import get_model as jax_get_model
from squeezedet_tpu.models import layers as JL
from torch_threads import one_thread  # noqa: F401  (autouse)

NETS = ["squeezeDet", "squeezeDet+", "vgg16", "resnet50"]
H, W = 64, 96
# int8 activations: equal, or 1 apart on at most this share of elements
INT8_MISMATCH = 1e-4
# Behind a hybrid boundary (float layers, then int8 from ``start`` on) the
# float layers' f32 outputs differ in their last bits between the two
# packages' convs, so the boundary can round a value the other way, and
# each such flip spreads through the int8 layers after it.  squeezeDet
# from fire4 and ResNet50 from res4a measure no flip; VGG16 from conv3_1
# flips 1.8e-4 of conv3_1's outputs, which grow to 11.7 % of conv5_3's,
# at most 3 apart, with the f32 head 1.3e-4 of its range and det_probs
# 1.5e-5 from JAX's.  Per case: (most apart, share, head and probs atol
# relative to the head's range).
FLIPS = {("vgg16", "conv3_1"): (3, 0.15, 1e-3)}
# f32 values computed from equal integers (the head's dequantized preds)
F32_RTOL, F32_ATOL = 1e-6, 1e-6
# calibration scales: the same order statistics, f32 reductions
SCALE_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _nets(net):
    """(JAX detector, numpy params, port detector with the same weights)."""
    jdet = jax_get_model(net, tiny_test_config(net=net, image_width=W,
                                               image_height=H))
    params, _, _ = jdet.init(jax.random.key(0))
    params = jax.tree.map(np.asarray, params)
    tdet = st.get_model(net, st.tiny_test_config(net, W, H), device="cpu")
    tdet.backbone.load_state_dict(from_jax_params(params))
    return jdet, params, tdet


def _u8(seed=0, b=2):
    return np.random.RandomState(seed).randint(0, 255, (b, H, W, 3),
                                               np.uint8)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_tape(jdet, qparams, u8):
    cfg = jdet.cfg
    if JQ.INPUT_SCALE_KEY in qparams:
        x = JQ.quantize_images(jnp.asarray(u8), cfg.bgr_means,
                               qparams[JQ.INPUT_SCALE_KEY])
    else:
        x = normalize_images(jnp.asarray(u8), cfg.bgr_means,
                             jnp.dtype(cfg.compute_dtype))
    tape = {}
    jdet.backbone.apply(qparams, x, cfg, train=False, tape=tape)
    return {k: np.asarray(v) for k, v in tape.items()}


def _assert_int8_close(got, want, name, share=INT8_MISMATCH, most=1):
    assert got.dtype == want.dtype == np.int8, (name, got.dtype, want.dtype)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= most, (name, diff.max())
    assert (diff > 0).mean() <= share, (name, (diff > 0).mean())


def test_input_scale_and_quantize_images_match_jax():
    """The exact input bound; the uint8 -> int8 image quantization equals
    JAX's and never clips."""
    means = (103.939, 116.779, 123.68)
    s = TQ.input_scale(means)
    assert s == JQ.input_scale(means)
    u8 = np.repeat(np.arange(256, dtype=np.uint8).reshape(1, 8, 32, 1), 3,
                   axis=3)
    got = TQ.quantize_images(torch.from_numpy(u8), means, s).numpy()
    want = np.asarray(JQ.quantize_images(jnp.asarray(u8), means, s))
    np.testing.assert_array_equal(got, want)
    x = u8.astype(np.float64) - np.asarray(means)
    assert np.abs(x / s).max() <= 127.0 + 1e-6
    f = _u8(3).astype(np.float32) - np.asarray(means, np.float32)
    np.testing.assert_array_equal(
        TQ.quantize_images_normalized(torch.from_numpy(f), s).numpy(),
        np.asarray(JQ.quantize_images_normalized(jnp.asarray(f), s)))


@pytest.mark.parametrize("ksize,stride,padding,relu", [
    (3, 1, "SAME", True), (1, 1, "SAME", True), (3, 2, "SAME", True),
    (3, 2, "VALID", True), (7, 2, "VALID", True), (3, 1, "SAME", False),
])
def test_int8_conv_matches_jax(ksize, stride, padding, relu):
    """The im2col + _int_mm conv against the JAX int8 conv: int8 outputs
    equal, the f32 head's within F32_RTOL; O=5 and C*k*k=8*k*k make the
    GEMM pad N and (for 1x1 and 7x7) K."""
    rng = np.random.RandomState(0)
    x = rng.randint(-128, 128, (2, 9, 11, 8)).astype(np.int8)
    k = rng.randint(-127, 128, (ksize, ksize, 8, 5)).astype(np.int8)
    mult = rng.uniform(1e-4, 1e-2, 5).astype(np.float32)
    bias = rng.uniform(-1, 1, 5).astype(np.float32)
    want = np.asarray(JL.conv2d(
        {"kernel": jnp.asarray(k), "mult": jnp.asarray(mult),
         "bias": jnp.asarray(bias)}, jnp.asarray(x), stride, padding,
        relu=relu))
    conv = TL.QConv(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                    torch.from_numpy(mult), torch.from_numpy(bias))
    got = TL.conv2d(conv, torch.from_numpy(x), stride, padding,
                    relu=relu).numpy()
    if relu:
        _assert_int8_close(got, want, "conv")
    else:
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)


def test_int8_conv_pair_and_boundary_match_jax():
    """The virtual concat (one accumulator over both halves' taps) and the
    float -> int8 boundary of a first int8 layer, against JAX's."""
    rng = np.random.RandomState(1)
    xa = rng.randint(-128, 128, (2, 6, 7, 16)).astype(np.int8)
    xb = rng.randn(2, 6, 7, 8).astype(np.float32) * 3.0
    k = rng.randint(-127, 128, (3, 3, 24, 16)).astype(np.int8)
    mult = rng.uniform(1e-4, 1e-2, 16).astype(np.float32)
    bias = rng.uniform(-1, 1, 16).astype(np.float32)
    in_scale = np.float32(0.05)
    jp = {"kernel": jnp.asarray(k), "mult": jnp.asarray(mult),
          "bias": jnp.asarray(bias), "in_scale": in_scale}
    conv = TL.QConv(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                    torch.from_numpy(mult), torch.from_numpy(bias),
                    in_scale=float(in_scale))
    want = np.asarray(JL.conv2d_pair(jp, jnp.asarray(xa), jnp.asarray(xb)))
    got = TL.conv2d_pair(conv, torch.from_numpy(xa),
                         torch.from_numpy(xb)).numpy()
    _assert_int8_close(got, want, "pair")
    np.testing.assert_array_equal(
        TL.quantize_activation(torch.from_numpy(xb), in_scale).numpy(),
        np.asarray(JL.quantize_activation(jnp.asarray(xb), in_scale)))


@pytest.mark.parametrize("size,stride,padding", [
    (3, 2, "SAME"), (3, 2, "VALID"), (2, 2, "SAME"), (3, 1, "SAME")])
def test_int8_max_pool_matches_jax(size, stride, padding):
    """Pooled in bf16 and cast back: JAX's integer reduce_window, whose
    SAME pad is int8's minimum."""
    x = np.random.RandomState(2).randint(-128, 128, (2, 9, 12, 4)) \
        .astype(np.int8)
    got = TL.max_pool(torch.from_numpy(x), size, stride, padding).numpy()
    want = np.asarray(JL.max_pool(jnp.asarray(x), size, stride, padding))
    np.testing.assert_array_equal(got, want)


def test_percentile_matches_jnp():
    """The "linear" percentile from two order statistics, at sizes where
    the position falls between elements and on them: jnp.percentile's
    value as calibration computes it (q a constant of the jitted program),
    and numpy's on the same data in float64 to 1e-4, the share of a gap
    between order statistics that an f32 position can miss."""
    rng = np.random.RandomState(4)
    for n, q in [(1000, 99.99), (4097, 50.0), (10, 10.0), (1, 99.0),
                 (123457, 99.9), (786432, 99.99), (100, 0.0), (100, 100.0)]:
        a = np.abs(rng.randn(n)).astype(np.float32)
        got = float(TQ.percentile(torch.from_numpy(a), q))
        want = float(jax.jit(lambda x: jnp.percentile(x, q))(
            jnp.asarray(a)))
        assert got == pytest.approx(want, rel=1e-6, abs=0), (n, q)
        assert got == pytest.approx(
            float(np.percentile(a.astype(np.float64), q)), rel=1e-4), (n, q)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("q", [None, 99.99, 10.0])
def test_calibrate_matches_jax(net, q):
    """Abs-max, a high percentile and a low one that lands on the
    post-ReLU zeros (falling back to abs-max): the same layers, scales
    within SCALE_RTOL of the layer's abs-max (a low percentile of the f32
    head lands on values near 0, whose f32 rounding differs between the
    two packages' convs by more than 1e-5 of their size).  The taped
    forward runs conv1 unfused."""
    jdet, params, tdet = _nets(net)
    u8 = [_u8(0), _u8(1)]
    want = JQ.calibrate(jdet, params, u8, percentile=q)
    top = JQ.calibrate(jdet, params, u8) if q is not None else want
    got = TQ.calibrate(tdet, u8, percentile=q)
    assert sorted(got) == sorted(want)
    for k in want:
        assert want[k] > 0
        assert abs(got[k] - want[k]) <= SCALE_RTOL * top[k], k


QUANT_CASES = [("squeezeDet", ""), ("squeezeDet", "fire4"),
               ("squeezeDet+", ""), ("vgg16", ""), ("vgg16", "conv3_1"),
               ("resnet50", ""), ("resnet50", "res4a")]


@pytest.mark.parametrize("net,start", QUANT_CASES)
def test_quantize_detector_matches_jax(net, start):
    """From the same float weights and the same scales: the same tree
    (which layers are int8, in_scale, ResNet's out_scale and
    shortcut_scale, the input scale), int8 kernels bit for bit, mult and
    bias within 1e-6; the int8 detector holds exactly that tree, and the
    float one is left as it was."""
    jdet, params, tdet = _nets(net)
    scales = JQ.calibrate(jdet, params, [_u8()])
    want = dict(_leaves(jax.tree.map(
        np.asarray, JQ.quantize_detector(jdet, params, scales,
                                         start=start))))
    tree = TQ.quantized_tree(tdet, scales, start=start)
    got = dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = np.asarray(got[path])
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=str(path))
    before = {k: v.clone() for k, v in tdet.state_dict().items()}
    qdet = TQ.quantize_detector(tdet, scales, start=start)
    for k, v in tdet.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert qdet.quantized and not tdet.quantized
    qstate = qdet.backbone.state_dict()
    expected = _expected_state(tree)
    assert sorted(qstate) == sorted(expected)
    for k, v in expected.items():
        np.testing.assert_array_equal(qstate[k].numpy(), v, err_msg=k)
    has_input = JQ.INPUT_SCALE_KEY in tree
    assert (getattr(qdet, "input_scale", None) is not None) == has_input
    if has_input:
        assert float(qdet.input_scale) == float(tree[JQ.INPUT_SCALE_KEY])


def _expected_state(tree):
    """The backbone state_dict an int8 detector of ``tree`` holds: a
    QConv's int8 OIHW weight, mult, bias and in_scale; a float layer's
    leaves as the weight bridge maps them; block scales."""
    out = {}
    for name, node in tree.items():
        if name == JQ.INPUT_SCALE_KEY:
            continue
        if not isinstance(node, dict):
            out[name] = np.asarray(node)  # a ResNet block's scale
        elif "mult" in node:
            out[name + ".weight"] = node["kernel"].transpose(3, 2, 0, 1)
            for leaf in ("mult", "bias", "in_scale"):
                if leaf in node:
                    out[name + "." + leaf] = np.asarray(node[leaf])
        elif "kernel" in node:
            out.update((name + "." + k, v.numpy()) for k, v in
                       from_jax_params(node).items())
        else:
            out.update(_expected_state(
                {name + "." + k: v for k, v in node.items()}))
    return out


@pytest.mark.parametrize("net,start", QUANT_CASES)
def test_int8_forward_matches_jax(net, start):
    """The port's int8 forward on ``from_jax_qparams`` of JAX's own int8
    tree: every taped activation against JAX's (int8 as INT8_MISMATCH
    says, or FLIPS behind a hybrid boundary; float layers before the
    boundary and the f32 head within 1e-5 of each layer's range), the
    uint8 entry equal to the mean-subtracted entry, det_probs within
    1e-6 (or FLIPS)."""
    jdet, params, tdet = _nets(net)
    most, share, atol = FLIPS.get((net, start), (1, INT8_MISMATCH, 1e-5))
    u8 = _u8(5)
    qp = jax.tree.map(np.asarray, JQ.quantize(jdet, params, [_u8(0)],
                                              start=start))
    qdet = from_jax_qparams(tdet, qp)
    want = _jax_tape(jdet, qp, u8)
    got = {}
    with torch.inference_mode():
        preds = qdet.backbone(qdet.quant_input(torch.from_numpy(u8)),
                              tape=got)
    assert list(got) == list(want)
    for k, w in want.items():
        if w.dtype == np.int8:
            _assert_int8_close(got[k].numpy(), w, k, share, most)
        else:
            np.testing.assert_allclose(
                got[k].float().numpy(), w, rtol=0,
                atol=atol * max(np.abs(w).max(), 1.0), err_msg=k)
    interp = qdet.predict_quant(torch.from_numpy(u8))
    f = torch.from_numpy(u8.astype(np.float32) - tdet.cfg.bgr_means_array())
    interp_n = qdet.predict_quant_normalized(f)
    for name in ("det_boxes", "det_probs", "det_class"):
        assert torch.equal(getattr(interp, name), getattr(interp_n, name))
    jinterp = jdet.predict_quant(qp, jnp.asarray(u8))
    np.testing.assert_allclose(interp.det_probs.numpy(),
                               np.asarray(jinterp.det_probs), rtol=0,
                               atol=max(atol / 10, 1e-6))
    assert preds.dtype == torch.float32


@pytest.mark.parametrize("net", NETS)
def test_int8_tracks_float(net):
    """JAX's own int8-vs-float bar (tests/test_quant.py), on the port's
    calibrate + quantize: box correlation > 0.999, probs within 0.02."""
    _, _, tdet = _nets(net)
    u8 = torch.from_numpy(_u8())
    qdet = tdet.quantize([u8])
    fi = tdet.predict_raw(u8)
    qi = qdet.predict_quant(u8)
    a, b = fi.det_boxes.numpy().ravel(), qi.det_boxes.numpy().ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.999
    assert (fi.det_probs - qi.det_probs).abs().max().item() < 0.02


def test_k1_runs_in_float_and_hybrid_forwards_only(monkeypatch):
    """squeezeDet's conv1+pool1 goes through K1's wrapper (the registered
    op) once per forward of the float detector and of a hybrid int8 one
    (start after conv1), and never in whole-net int8 or a taped forward
    (which records conv1 before the pool)."""
    _, _, tdet = _nets("squeezeDet")
    calls = []
    real = ff.conv1_pool1
    monkeypatch.setattr(ff, "conv1_pool1",
                        lambda *a: calls.append(1) or real(*a))
    u8 = torch.from_numpy(_u8())
    whole = tdet.quantize([u8])
    hybrid = tdet.quantize([u8], start="fire2")
    assert calls == []  # calibration tapes conv1 unfused
    tdet.predict_raw(u8)
    assert len(calls) == 1
    hybrid.predict_quant(u8)
    assert len(calls) == 2
    whole.predict_quant(u8)
    assert len(calls) == 2
    assert isinstance(whole.backbone.conv1, TL.QConv)
    assert isinstance(hybrid.backbone.conv1, TL.Conv)
    assert hybrid.backbone.fire2.squeeze1x1.in_scale is not None


def test_resnet50_block_structure():
    """conv1 float, batch norm folded into the int8 blocks, a projection
    shortcut with in_scale at the boundary, out_scale on every int8 block
    and shortcut_scale on the identity joins after it."""
    _, _, tdet = _nets("resnet50")
    qdet = tdet.quantize([torch.from_numpy(_u8())])
    bb = qdet.backbone
    assert isinstance(bb.conv1, TL.ConvBN)
    assert isinstance(bb.res2a.branch2.branch2a, TL.QConv)
    assert bb.res2a.branch2.branch2a.in_scale is not None
    assert bb.res2a.branch1.in_scale is not None
    assert bb.res2a.out_scale is not None
    assert getattr(bb.res2a, "shortcut_scale", None) is None
    assert bb.res2b.shortcut_scale is not None
    assert isinstance(bb.conv5, TL.QConv)
    assert getattr(qdet, "input_scale", None) is None


@pytest.mark.parametrize("net", ["squeezeDet", "resnet50"])
def test_float_tape_matches_jax(net):
    """The float taped forward records JAX's layer names in JAX's order,
    with the same activations (f32, up to summation order)."""
    jdet, params, tdet = _nets(net)
    u8 = _u8(6)
    cfg = jdet.cfg
    jt = {}
    jdet.backbone.apply(params, normalize_images(
        jnp.asarray(u8), cfg.bgr_means, jnp.float32), cfg, train=False,
        tape=jt)
    tt = {}
    from squeezedet_torch.data.device_pipeline import \
        normalize_images as tnorm
    with torch.inference_mode():
        tdet.backbone(tnorm(torch.from_numpy(u8), cfg.bgr_means), tape=tt)
    assert list(tt) == list(jt)
    for k, w in jt.items():
        w = np.asarray(w)
        np.testing.assert_allclose(tt[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


@pytest.mark.parametrize("q", [None, 99.0])
def test_quant_report_rows_match_jax(q):
    """``tools/quant_report.report``: the JAX tool's rows (layer, scale,
    utilization, SNR) on the same weights and frames."""
    from squeezedet_torch.tools.quant_report import report
    from squeezedet_tpu.tools.quant_report import report as jax_report
    jdet, params, tdet = _nets("squeezeDet")
    u8 = _u8(7)
    want, _ = jax_report(jdet, params, u8, percentile=q)
    got, qdet = report(tdet, u8, percentile=q)
    assert qdet.quantized
    # JAX's rows follow its jitted tape, whose keys come back sorted
    got = sorted(got)
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert g[1] == pytest.approx(w[1], rel=SCALE_RTOL), g[0]
        if w[2] == w[2]:
            assert g[2] == pytest.approx(w[2], abs=1.0), g[0]
        else:
            assert g[2] != g[2]
        assert g[3] == pytest.approx(w[3], abs=0.05), g[0]
        if q is None:  # JAX's bar for its abs-max report
            assert g[3] > 15.0


def test_quant_report_cli(capsys):
    from squeezedet_torch.tools import quant_report
    quant_report.main(["--device", "cpu", "--image_width", "96",
                       "--image_height", "64", "--batch_size", "2"])
    out = capsys.readouterr().out
    assert "conv12" in out and "worst layer:" in out


def test_calib_batch_from_images(tmp_path):
    """A directory, a glob and one file give the frames resized to the
    model resolution, as OpenCV reads and resizes them; the resize
    without OpenCV is the device pipeline's bilinear one, within a grey
    level of OpenCV's on a smooth image."""
    import cv2
    rng = np.random.RandomState(8)
    for i in range(3):
        cv2.imwrite(str(tmp_path / "f{}.png".format(i)),
                    rng.randint(0, 256, (50, 70, 3)).astype(np.uint8))
    batch = TQ.calib_batch_from_images(str(tmp_path), W, H)
    assert batch.shape == (3, H, W, 3) and batch.dtype == np.uint8
    want = cv2.resize(cv2.imread(str(tmp_path / "f0.png")), (W, H))
    np.testing.assert_array_equal(batch[0], want)
    assert TQ.calib_batch_from_images(str(tmp_path / "*.png"), W, H,
                                      limit=2).shape[0] == 2
    assert TQ.calib_batch_from_images(str(tmp_path / "f1.png"), W,
                                      H).shape[0] == 1
    smooth = np.tile(np.linspace(0, 255, 70)[None, :, None],
                     (50, 1, 3)).astype(np.uint8)
    got = TQ._resize_u8(smooth, W, H).astype(int)
    assert np.abs(got - cv2.resize(smooth, (W, H)).astype(int)).max() <= 1
    with pytest.raises(ValueError, match="no readable"):
        TQ.calib_batch_from_images(str(tmp_path / "none*.png"), W, H)
