"""The port's spatial partitioning (``models/halo.py``,
``parallel/spatial.py``, batch-1 spatial eval) on the CPU, against the
JAX package's spatially sharded programs and against the port's own
unsharded forward.

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``;
the port's tiles all live on the CPU.  Weights cross over through
``weights.from_jax_params``.  Tolerances are ``tests/test_spatial.py``'s
(boxes rtol/atol 1e-4, probs rtol 1e-4 atol 1e-6, classes equal); the
whole-net int8 program is held to the unsharded int8 one exactly.
JAX is imported inside the tests that use it, so that the
``cuda``-marked cases run on a machine without it
(``python -m pytest --noconftest -m cuda tests/test_torch_spatial.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import eval as port_eval
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.models import halo
from squeezedet_torch.models import squeezedet as port_squeezedet
from squeezedet_torch.ops import fused_frontend as ff
from squeezedet_torch.parallel import mesh as port_mesh
from squeezedet_torch.parallel.spatial import spatial_predict_fn
from squeezedet_torch.weights import from_jax_params
from synth_kitti import make_synth_kitti
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
HEAD_STD, BIAS_STD = 0.05, 0.1


def _assert_interp_close(got, want):
    """``tests/test_spatial.py``'s tolerances on (boxes, probs, classes)."""
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))


def _jax_and_port(width, height, batch, seed):
    """The JAX detector and its params (random biases, a wider head), and
    the port's detector with the same weights."""
    import jax
    from squeezedet_tpu.config import tiny_test_config as jax_tiny_config
    from squeezedet_tpu.models import get_model as jax_get_model
    jdet = jax_get_model("squeezeDet", jax_tiny_config(
        image_width=width, image_height=height, batch_size=batch))
    params, _, _ = jdet.init(jax.random.key(seed))
    rng = np.random.RandomState(seed)

    def perturb(path, p):
        if path[-1].key == "bias":
            return rng.randn(*p.shape).astype(np.float32) * BIAS_STD
        if path[0].key == "conv12":
            return rng.randn(*p.shape).astype(np.float32) * HEAD_STD
        return np.asarray(p)
    params = jax.tree_util.tree_map_with_path(perturb, params)
    det = st.get_model("squeezeDet", st.tiny_test_config(
        image_width=width, image_height=height, batch_size=batch),
        device="cpu")
    det.backbone.load_state_dict(from_jax_params(params))
    return jdet, params, det


def _perturbed(width, height, batch, seed):
    """The port's squeezeDet with seeded weights, random biases and a
    wider head, as ``_jax_and_port`` perturbs the JAX package's."""
    det = st.get_model("squeezeDet", st.tiny_test_config(
        image_width=width, image_height=height, batch_size=batch),
        device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in det.backbone.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(
                    np.float32) * BIAS_STD))
            elif name.startswith("conv12"):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(
                    np.float32) * HEAD_STD))
    return det


def _port_model(net, width, height, seed=0):
    """A seeded port detector whose head is rescaled so that its box
    deltas have std 1 on uint8 frames, as ``chip_smoke.py``'s are."""
    det = st.get_model(net, st.tiny_test_config(
        net, image_width=width, image_height=height, batch_size=1),
        device="cpu", generator=torch.Generator().manual_seed(seed))
    u8 = _u8(np.random.RandomState(seed), 2, height, width)
    with torch.no_grad():
        spread = det.predict_raw(u8).pred_box_delta.std().item()
        det.layers()[-1].weight.mul_(1.0 / spread)
    return det


def _u8(rs, b, h, w):
    return torch.from_numpy(rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8))


@pytest.mark.parametrize("n, h, w, want", [
    (8, 384, 1248, (8, 1)), (8, 96, 320, (2, 4)), (8, 128, 320, (8, 1)),
    (8, 176, 208, (1, 1)), (8, 80, 208, (5, 1))])
def test_spatial_factors_cases(n, h, w, want):
    """``tests/test_eval_dp.py``'s five cases."""
    assert port_mesh.spatial_factors(n, h, w) == want


def test_spatial_factors_equal_jax():
    from squeezedet_tpu.parallel import mesh as jax_mesh
    sizes = [(384, 1248), (375, 1242), (96, 320), (128, 320), (176, 208),
             (80, 208), (64, 64), (96, 96), (80, 112), (48, 80)]
    for n in range(1, 9):
        for h, w in sizes:
            assert port_mesh.spatial_factors(n, h, w) == \
                jax_mesh.spatial_factors(n, h, w), (n, h, w)


def test_spatial_predict_matches_jax_on_2x4_mesh():
    """``make_mesh_2d(2, 4)`` at 64x64 B=2 (batch over 2 data
    coordinates, height over 4 tiles) against the JAX package's
    ``spatial_predict_fn`` on the same mesh."""
    import jax
    from squeezedet_tpu.parallel import mesh as jax_mesh
    from squeezedet_tpu.parallel.spatial import spatial_predict_fn as jax_spf
    jdet, params, det = _jax_and_port(64, 64, 2, 0)
    im = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    jmesh = jax_mesh.make_mesh_2d(2, 4)
    want = jax_spf(jdet, jmesh, postprocess=False)(
        jax.device_put(params, jax_mesh.replicated_sharding(jmesh)),
        jax.device_put(im, jax_mesh.image_sharding(jmesh)))
    mesh = port_mesh.make_mesh_2d(2, 4, "cpu")
    got = spatial_predict_fn(det, mesh, postprocess=False)(
        torch.from_numpy(im))
    _assert_interp_close([t.numpy() for t in got], want)


def test_spatial_only_batch1_postprocess_matches_jax():
    """(1, 8) at 96x96 B=1 with the on-device top-K + NMS (eight height
    tiles over a 6-row grid: two tiles own no row) against the JAX
    package's unsharded forward and ``filter_prediction_device``."""
    import jax
    import jax.numpy as jnp
    from squeezedet_tpu.ops.postprocess import filter_prediction_device
    jdet, params, det = _jax_and_port(96, 96, 1, 1)
    cfg = jdet.cfg
    im = np.random.RandomState(1).randn(1, 96, 96, 3).astype(np.float32)

    def host_fn(p, x):
        interp = jdet.predict(p, x)
        return filter_prediction_device(
            interp.det_boxes, interp.det_probs, interp.det_class,
            top_n=cfg.top_n_detection, nms_thresh=cfg.nms_thresh,
            num_classes=cfg.classes, prob_thresh=cfg.prob_thresh)
    want = jax.jit(host_fn)(params, jnp.asarray(im))
    fn = spatial_predict_fn(det, port_mesh.make_mesh_2d(1, 8, "cpu"))
    with halo.trace() as ops:
        got = fn(torch.from_numpy(im))
    assert any(0 in sum(op["heights"], []) for op in ops)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w).astype(np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grid", [(2, 2), (3, 1), (5, 1), (1, 3)],
                         ids=lambda g: "{}x{}".format(*g))
def test_tile_grids_match_unsharded(grid):
    """Uneven splits (24 rows of 112x80's 5-row grid over 3 and 5
    tiles), a width split and a 2x2 grid, uint8 -> raw interpretation
    and -> detections, against the unsharded forward."""
    det = _perturbed(112, 80, 1, 2)
    u8 = _u8(np.random.RandomState(2), 1, 80, 112)
    tiling = port_mesh.make_mesh_spatial(*grid, device="cpu").tiling()
    want = det.predict_raw(u8)
    got = det.predict_raw(u8, spatial=tiling)
    _assert_interp_close([got.det_boxes, got.det_probs, got.det_class],
                         [want.det_boxes, want.det_probs, want.det_class])
    want_pp = det.predict_raw_postprocessed(u8)
    got_pp = det.predict_raw_postprocessed(u8, spatial=tiling)
    for g, w in zip(got_pp, want_pp):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   w.numpy().astype(np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)],
                         ids=lambda g: "{}x{}".format(*g))
@pytest.mark.parametrize("net", ["squeezeDet+", "vgg16", "resnet50"])
def test_other_backbones_match_unsharded(net, grid):
    """The other nets at an odd frame (VALID stages, odd extents): each
    stage's split follows from its op's kernel, stride and padding."""
    det = _port_model(net, 120, 101)
    u8 = _u8(np.random.RandomState(3), 1, 101, 120)
    tiling = port_mesh.make_mesh_spatial(*grid, device="cpu").tiling()
    want = det.predict_raw(u8)
    with halo.trace() as ops:
        got = det.predict_raw(u8, spatial=tiling)
    assert ops and all(max(sum(op["heights"], [])) < op["rows"][-1]
                       for op in ops)
    _assert_interp_close([got.det_boxes, got.det_probs, got.det_class],
                         [want.det_boxes, want.det_probs, want.det_class])


@pytest.mark.parametrize("net", ["squeezeDet", "resnet50"])
def test_int8_spatial_equals_unsharded_exactly(net):
    """The whole-net int8 program over the ``spatial_factors`` grid of 4
    devices (4x1 at 64x64), and over an uneven 3x2 grid, equals the
    unsharded int8 program bit for bit: raw preds and the int8 tape."""
    det = _port_model(net, 64, 64)
    rs = np.random.RandomState(4)
    qdet = det.quantize([_u8(rs, 1, 64, 64).numpy()])
    u8 = _u8(rs, 1, 64, 64)
    want_tape = {}
    want = qdet.run_backbone(qdet.quant_input(u8), tape=want_tape)
    assert port_mesh.spatial_factors(4, 64, 64) == (4, 1)
    for grid in [(4, 1), (3, 2)]:
        tiling = port_mesh.make_mesh_spatial(*grid, device="cpu").tiling()
        tape = {}
        got = qdet.run_backbone(qdet.quant_input(u8), spatial=tiling,
                                tape=tape)
        assert torch.equal(got, want)
        assert set(tape) == set(want_tape)
        for name in want_tape:
            assert torch.equal(tape[name], want_tape[name]), name
        a, b = qdet.predict_quant(u8, tiling), qdet.predict_quant(u8)
        assert torch.equal(a.det_boxes, b.det_boxes)
        assert torch.equal(a.det_probs, b.det_probs)
    fn = spatial_predict_fn(qdet, port_mesh.make_mesh_2d(1, 2, "cpu"),
                            postprocess=False, uint8_input=True)
    for g, w in zip(fn(u8), (b.det_boxes, b.det_probs, b.det_class)):
        assert torch.equal(g, w)


def test_forward_keeps_tiles_and_exchanges_halos():
    """The counterpart of ``test_spatial_program_has_halo_exchanges``:
    halo pieces are fetched, every stage's tile bounds are the plan's
    (the 16-pixel grid split halved at each stride-2 op), each tile's
    height and width are its bounds', and no tile before the head holds
    the whole frame's height."""
    det = _perturbed(64, 64, 2, 0)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 64, 64, 3)
                         .astype(np.float32))
    tiling = port_mesh.make_mesh_spatial(4, 2, device="cpu").tiling()
    copies, nbytes = halo.COPIES, halo.BYTES
    with halo.trace() as ops:
        det.predict(x, spatial=tiling)
    assert halo.COPIES > copies and halo.BYTES > nbytes
    stages = [(tuple(r >> k for r in (0, 16, 32, 48, 64)),
               tuple(c >> k for c in (0, 32, 64))) for k in range(5)]
    stride = {"conv1_pool1": 4, "max_pool": 2}
    for op in ops:
        k = stages.index((op["in_rows"], op["in_cols"]))
        k += stride.get(op["op"], 1).bit_length() - 1
        rows, cols = stages[k]
        assert (op["rows"], op["cols"]) == stages[k], op["op"]
        assert op["heights"] == [[rows[i + 1] - rows[i]] * 2
                                 for i in range(4)]
        assert op["widths"] == [[cols[j + 1] - cols[j]
                                 for j in range(2)]] * 4
        assert max(sum(op["heights"], [])) < op["rows"][-1]
    assert ops[0]["op"] == "conv1_pool1" and ops[0]["in_rows"][1] == 16
    assert ops[-1]["op"] == "conv12" and ops[-1]["rows"] == (0, 1, 2, 3, 4)


@pytest.mark.parametrize("h, w, cuts", [
    (64, 96, ((0, 5), (0, 7))), (37, 51, ((0, 3), (0,))),
    (375, 1242, ((0, 24, 47), (0, 100)))])
def test_k1_tile_geometry_plain(h, w, cuts):
    """K1's plain version at each tile's geometry equals the frame's
    pooled output at the tile's rows and columns, odd frames (a leading
    SAME pad) included."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(2, h, w, 3).astype(np.float32))
    k = torch.from_numpy(rs.randn(3, 3, 3, 64).astype(np.float32))
    b = torch.from_numpy(rs.randn(64).astype(np.float32))
    full = ff.conv1_pool1_reference(x, k, b)
    rows, cols = cuts
    rows, cols = rows + (full.shape[1],), cols + (full.shape[2],)
    for q in zip(rows, rows[1:]):
        for p in zip(cols, cols[1:]):
            (r, c), geo = ff.tile_geometry(h, w, q, p)
            tile = ff.conv1_pool1_reference(
                x[:, r[0]:r[1], c[0]:c[1]].contiguous(), k, b, list(geo))
            torch.testing.assert_close(
                tile, full[:, q[0]:q[1], p[0]:p[1]], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size, k, s, padding", [
    (64, 3, 2, "SAME"), (37, 3, 2, "SAME"), (37, 7, 2, "SAME"),
    (25, 3, 1, "SAME"), (26, 2, 2, "VALID"), (13, 3, 2, "VALID")])
def test_chain_window_of_one_op_is_the_op_window(size, k, s, padding):
    """Through a single op, ``chain_window`` gives the op's window
    clamped to the input and, as the leading pad, the positions the
    clamp took off its start: the rule ``windowed`` fetches by."""
    out = halo._out_geometry(size, k, s, padding)[0]
    for q in [(0, out), (0, 1), (out // 2, out), (1, max(out - 1, 2))]:
        lo, hi = halo.op_window(*q, size, k, s, padding)
        win, [(extent, lead)] = halo.chain_window(q, size,
                                                  [(k, s, padding)])
        assert win == (max(lo, 0), min(hi, size))
        assert (extent, lead) == (q[1] - q[0], max(-lo, 0))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_on_tiles_matches_plain_on_card(dtype):
    """K1 launched once per tile of a 4x2 tiling at 384x1248 equals its
    plain version on the same windows (f32: 1e-4 + 1e-5 relative; bf16:
    two ulps, as ``chip_smoke.py``'s K1 check)."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(1, 384, 1248, 3).astype(np.float32))
    k = torch.from_numpy(rs.randn(3, 3, 3, 64).astype(np.float32) * 0.1)
    b = torch.from_numpy(rs.randn(64).astype(np.float32) * 0.1)
    tiling = port_mesh.make_mesh_spatial(4, 2, device="cuda").tiling()
    tiles = tiling.split(x.cuda().to(dtype), 24, 78)
    launches = ff.LAUNCHES
    got = port_squeezedet.conv1_pool1(tiles, k.cuda(), b.cuda()).gather()
    assert ff.LAUNCHES - launches == 8
    want = ff.conv1_pool1_reference(x.to(dtype), k, b)
    tol = (1e-4, 1e-5) if dtype == torch.float32 else (1.6e-2, 1e-4)
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU")
def test_spatial_step_on_card_matches_unsharded():
    """The train step over (1, 2) height tiles on the card (K1 once per
    tile) against the unsharded step on the card, f32 with TF32 off,
    dropout on, from the same weights and generator."""
    from squeezedet_torch.optim import build_optimizer
    from squeezedet_torch.trainer import TrainState, make_train_step_device
    torch.backends.cudnn.allow_tf32 = False
    cfg = st.tiny_test_config(batch_size=2)
    rs = np.random.RandomState(8)
    boxes = np.stack([rs.uniform(15, 80, (2, 4)), rs.uniform(15, 80, (2, 4)),
                      rs.uniform(10, 40, (2, 4)), rs.uniform(10, 40, (2, 4))],
                     axis=-1).astype(np.float32)
    batch = [_u8(rs, 2, 96, 96), torch.from_numpy(boxes),
             torch.from_numpy(rs.randint(0, 3, (2, 4)).astype(np.int32)),
             torch.tensor([3, 1], dtype=torch.int32)]

    def run(spatial):
        det = st.get_model("squeezeDet", cfg, device="cuda")
        state = TrainState(det, build_optimizer(cfg, det))
        launches = ff.LAUNCHES
        lb = make_train_step_device(state, uint8_ingest=True,
                                    spatial=spatial)(
            *(t.cuda() for t in batch),
            generator=torch.Generator("cuda").manual_seed(3))
        return torch.stack(list(lb)).cpu(), ff.LAUNCHES - launches
    want, k1 = run(None)
    got, k1_tiles = run(port_mesh.make_mesh_2d(1, 2, "cuda").tiling())
    assert (k1, k1_tiles) == (1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_spatial"))
    make_synth_kitti(root, num_images=3, width=320, height=96,
                     image_set="val")
    return root


def _same_detections(got, want):
    for c in range(len(want)):
        for i in range(len(want[c])):
            a = np.asarray(sorted(map(tuple, want[c][i])))
            b = np.asarray(sorted(map(tuple, got[c][i])))
            assert a.shape == b.shape, (c, i)
            if a.size:
                np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_detect_all_batch1_spatial_equals_one_device(kitti_root, quant,
                                                     capsys):
    """Batch-1 eval over four CPU devices runs spatially (f32: 4x1; int8:
    ``spatial_factors(4, 64, 96)`` = 4x1) with the JAX eval's banner,
    and scores one device's detections."""
    det = _perturbed(96, 64, 1, 3)
    if quant:
        det = port_eval.quantize_on_split(det, Kitti("val", kitti_root,
                                                     det.cfg), 2)
    want, want_n, _ = port_eval.detect_all(det, Kitti("val", kitti_root,
                                                      det.cfg), 1)
    assert "spatially" not in capsys.readouterr().out
    got, got_n, _ = port_eval.detect_all(
        det, Kitti("val", kitti_root, det.cfg), 1,
        mesh=port_mesh.make_mesh(4, "cpu"))
    assert "Evaluating spatially over 4 devices" in capsys.readouterr().out
    assert got_n == want_n > 0
    _same_detections(got, want)


def test_int8_spatial_unavailable_geometry(kitti_root, capsys):
    """At 112x80 (5 x 7 grid cells) no split of 4 devices divides every
    stage, so int8 eval says so and runs on one device, as the JAX eval
    does; the resolved mesh at batch 1 is the tiles' devices."""
    det = _perturbed(112, 80, 1, 3)
    qdet = port_eval.quantize_on_split(det, Kitti("val", kitti_root,
                                                  det.cfg), 1)
    assert port_mesh.spatial_factors(4, 80, 112) == (1, 1)
    port_eval.detect_all(qdet, Kitti("val", kitti_root, det.cfg), 1,
                         mesh=port_mesh.make_mesh(4, "cpu"))
    out = capsys.readouterr().out
    assert "int8 spatial partitioning unavailable for this geometry" in out
    assert "spatially over" not in out
    args = port_eval.build_arg_parser().parse_args(["--num_devices", "4"])
    assert port_eval.resolve_mesh(args, CPU) == [CPU] * 4
    args = port_eval.build_arg_parser().parse_args([])
    assert port_eval.resolve_mesh(args, CPU) is None


def test_spatial_modules_import_no_jax():
    code = ("import sys; import squeezedet_torch.models.halo, "
            "squeezedet_torch.parallel.spatial; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'squeezedet_tpu')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_layers_and_k1_import_no_parallel_package():
    """The tile primitives sit under ``models/``: the layer library and
    K1's wrapper load nothing of ``squeezedet_torch.parallel``."""
    code = ("import sys; import squeezedet_torch.ops.fused_frontend, "
            "squeezedet_torch.models.layers; "
            "bad = [m for m in sys.modules "
            "if m.startswith('squeezedet_torch.parallel')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
