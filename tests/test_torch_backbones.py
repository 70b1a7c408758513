"""The squeezeDet+, VGG16 and ResNet50 backbones of the port against the
JAX package on the CPU: forward, uint8 -> detections, one train step,
K2's routing, structure at full size and the weight bridge.

Weights come from the JAX package's init at ``tiny_test_config(net)``,
with every bias, every batch-norm statistic (mean != 0, var > 0 away
from 1) and every gamma and beta perturbed, and the head drawn so that
the preds are O(1); they cross with ``weights.from_jax_params``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch.models import layers as TL
from squeezedet_torch.ops import filter_grad as fg
from squeezedet_torch.ops.boxes import pairwise_iou_center
from squeezedet_torch.optim import build_optimizer
from squeezedet_torch.trainer import TrainState, make_train_step_device
from squeezedet_torch.weights import (from_jax_opt_state, from_jax_params,
                                      pickle_from_jax_params, to_jax_opt_state,
                                      to_jax_params)
from squeezedet_tpu import trainer as JT
from squeezedet_tpu.config import config_for_net
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.models import get_model as jax_get_model
from squeezedet_tpu.models import layers as JL
from squeezedet_tpu.optim import build_optimizer as jax_build_optimizer
from squeezedet_tpu.optim import merge_params, partition_params
from torch_threads import one_thread  # noqa: F401  (autouse)

NETS = ["squeezeDet+", "vgg16", "resnet50"]
HEADS = {"squeezeDet+": "conv12", "vgg16": "conv6", "resnet50": "conv5"}
# K2 calls per train-step backward in filter-grad mode True, as the JAX
# package routes them (widths, hence eligibility, are those of the full
# config): squeezeDet+'s 1x1 squeezes on 128/256-channel halves, its
# fire8-11 expands (C=384) and conv12's two halves; VGG16's trained 3x3
# convs from conv3_1 on; ResNet50's head
K2_CALLS = {"squeezeDet+": 20, "vgg16": 10, "resnet50": 1}
CFG_KW = dict(keep_prob=1.0, lr_warmup_steps=8, learning_rate=0.01)
# One f32 train step, port against JAX: each updated leaf and momentum
# buffer within STEP_TOL of that leaf's update (L2).  The packages sum in
# other orders; on squeezeDet+ XLA's f32 CPU backward is itself off by
# 2.4e-3 of fire2's largest expand3x3 gradient (measured against float64,
# in which both packages agree to 1e-12: test_backward_matches_jax_in_
# float64), which the step's clipping and momentum carry to 1.4e-2 of the
# update; the others measure 8e-4 (vgg16) and 3e-5 (resnet50).
STEP_TOL = {"squeezeDet+": 3e-2, "vgg16": 2e-3, "resnet50": 2e-3}


def _perturb(tree, rng):
    """Biases N(0, 0.1); BN mean N(0, 0.2), var U(0.3, 3), gamma U(0.5,
    1.5), beta N(0, 0.1): every term of every layer is exercised."""
    draw = {"bias": lambda s: rng.randn(*s) * 0.1,
            "mean": lambda s: rng.randn(*s) * 0.2,
            "var": lambda s: rng.uniform(0.3, 3.0, s),
            "gamma": lambda s: rng.uniform(0.5, 1.5, s),
            "beta": lambda s: rng.randn(*s) * 0.1}
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = _perturb(value, rng)
        elif name in draw:
            out[name] = draw[name](value.shape).astype(np.float32)
        else:
            out[name] = value
    return out


@functools.lru_cache(maxsize=None)
def _jax_net(net, **kw):
    """(JAX detector, perturbed numpy params, trainable mask) at the tiny
    config of ``net``; the head is N(0, 1) scaled so the preds have std
    ~1."""
    jdet = jax_get_model(net, tiny_test_config(net).replace(**kw))
    params, mask, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)
    tree = _perturb(jax.tree.map(np.asarray, params), rng)
    head = tree[HEADS[net]]
    head["kernel"] = rng.randn(*head["kernel"].shape).astype(np.float32)
    x = jnp.asarray(_images(np.random.RandomState(9), jdet.cfg))
    spread = float(np.std(np.asarray(jdet.forward(tree, x))))
    head["kernel"] = head["kernel"] / np.float32(spread)
    head["bias"] = head["bias"] / np.float32(spread)
    return jdet, tree, mask


def _images(rng, cfg, b=2):
    return (rng.rand(b, cfg.image_height, cfg.image_width, 3) * 255
            - 120).astype(np.float32)


def _port(net, tree, **kw):
    det = st.get_model(net, st.tiny_test_config(net).replace(**kw),
                       device="cpu")
    det.backbone.load_state_dict(from_jax_params(tree))
    return det


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", NETS)
def test_tiny_preds_match_jax(net, dtype):
    """Backbone + head preds (std ~1): f32 to rtol 1e-4 / atol 1e-4;
    bf16, which rounds at other places in the two frameworks through up
    to 50 layers, to 6e-2 of the preds' largest magnitude."""
    jdet, tree, _ = _jax_net(net)
    jdet = jax_get_model(net, jdet.cfg.replace(compute_dtype=dtype))
    det = _port(net, tree, compute_dtype=dtype)
    x = _images(np.random.RandomState(2), jdet.cfg)
    want = np.asarray(jdet.forward(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = det(torch.from_numpy(x)).numpy()
    cfg = det.cfg
    assert got.shape == want.shape == (2, cfg.grid_h, cfg.grid_w, 72)
    assert got.dtype == np.float32 and np.abs(want).std() > 0.3
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=6e-2 * scale)


@pytest.mark.parametrize("net", NETS)
def test_uint8_to_detections_matches_jax(net):
    """uint8 -> (boxes, probs, classes, keep): order, classes and keep
    equal; boxes to 1e-3 px; probs to 1e-5.  Precondition, asserted: the
    reference's top-65 scores are separated by more than twice the
    largest score difference between the packages, and its same-class
    IoUs sit 1e-4 or more from nms_thresh."""
    jdet, tree, _ = _jax_net(net)
    det = _port(net, tree)
    cfg = det.cfg
    u8 = np.random.RandomState(0).randint(
        0, 256, (2, cfg.image_height, cfg.image_width, 3)).astype(np.uint8)
    jinterp = jdet.predict_raw(tree, jnp.asarray(u8))
    tinterp = det.predict_raw(torch.from_numpy(u8))
    jprobs = np.asarray(jinterp.det_probs)
    noise = np.abs(jprobs - tinterp.det_probs.numpy()).max()
    top = -np.sort(-jprobs, axis=1)[:, :65]
    assert (top[:, :-1] - top[:, 1:]).min() > 2 * noise

    want = [np.asarray(o) for o in
            jdet.predict_raw_postprocessed(tree, jnp.asarray(u8))]
    got = [o.numpy() for o in
           det.predict_raw_postprocessed(torch.from_numpy(u8))]
    boxes = torch.tensor(want[0])
    iou = pairwise_iou_center(boxes, boxes).numpy()
    same = (want[2][:, :, None] == want[2][:, None, :]) & \
        ~np.eye(64, dtype=bool)
    assert np.abs(iou - cfg.nms_thresh)[same].min() > 1e-4
    assert 0 < want[3].sum() < want[3].size  # NMS suppressed some

    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def _batch(rng, cfg):
    b, g = 2, 4
    w, h = cfg.image_width, cfg.image_height
    boxes = np.stack([rng.uniform(15, w - 15, (b, g)),
                      rng.uniform(15, h - 15, (b, g)),
                      rng.uniform(10, 40, (b, g)), rng.uniform(10, 40, (b, g))],
                     axis=-1).astype(np.float32)
    labels = rng.randint(0, 3, (b, g)).astype(np.int32)
    num_gt = np.array([3, 1], np.int32)
    u8 = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    return [u8, boxes, labels, num_gt]


@functools.lru_cache(maxsize=None)
def _jax_step(net):
    """The JAX package's train step (filter-grad routing off) from a
    mid-training optimizer state: a random trace at the trainable leaves,
    step 5.  Returns (start params, start opt state, batch, new params,
    new opt state, loss terms), as numpy."""
    jdet, tree, mask = _jax_net(net, **CFG_KW)
    rng = np.random.RandomState(3)
    params = jax.tree.map(jnp.asarray, tree)
    tx = jax_build_optimizer(jdet.cfg, mask)
    like = tx.init(params)
    trace = jax.tree.map(
        lambda p, m: jnp.asarray(rng.randn(*p.shape).astype(np.float32)
                                 * 1e-3) if m else jnp.zeros_like(p),
        params, mask)
    opt_state = (like[0], like[1], like[2]._replace(trace=trace),
                 like[3]._replace(count=jnp.asarray(5, jnp.int32)))
    batch = _batch(rng, jdet.cfg)
    step = JT.make_train_step_device(jdet, tx, donate=False,
                                     uint8_ingest=True)
    new_params, new_opt, lb = step(params, opt_state, *map(jnp.asarray, batch),
                                   jax.random.key(0))
    return (tree, opt_state, batch, jax.tree.map(np.asarray, new_params),
            new_opt, [float(v) for v in lb])


def _port_state(net, tree, opt_state):
    det = _port(net, tree, **CFG_KW)
    opt = build_optimizer(det.cfg, det)
    opt.load_state_dict(from_jax_opt_state(opt_state, det.trainable_mask()))
    return TrainState(det, opt)


def _run_step(state, batch, mode):
    """One make_train_step_device step in filter-grad ``mode``; returns
    (loss terms, K2 calls as (kh, C, O))."""
    calls = []
    real = fg.filter_grad

    def spy(x, dy, kh, kw):
        calls.append((kh, x.shape[-1], dy.shape[-1]))
        return real(x, dy, kh, kw)
    fg.filter_grad = spy
    try:
        TL.set_filter_grad(mode)
        lb = make_train_step_device(state, uint8_ingest=True)(
            *map(torch.from_numpy, batch))
    finally:
        TL.set_filter_grad(False)
        fg.filter_grad = real
    return [float(v) for v in lb], calls


@pytest.mark.parametrize("net", NETS)
def test_train_step_matches_jax(net):
    """Loss terms to rtol 1e-4; each updated trainable leaf within
    STEP_TOL of its update and each momentum buffer within STEP_TOL of
    its value (L2); frozen leaves, the batch-norm statistics included,
    bit-identical to where they started.  The port's state maps back
    onto the JAX chain's structure."""
    tree, opt_state, batch, new_params, new_opt, want = _jax_step(net)
    state = _port_state(net, tree, opt_state)
    before = {n: p.detach().clone()
              for n, p in state.det.backbone.state_dict().items()}
    got, calls = _run_step(state, batch, False)
    assert calls == [] and state.step == 6
    np.testing.assert_allclose(got, want, rtol=1e-4)

    mask = state.det.trainable_mask()
    want_p = from_jax_params(new_params)
    assert set(mask) == set(want_p) == set(before)
    for name, p in state.det.backbone.state_dict().items():
        if not mask[name]:
            assert torch.equal(p, before[name]), name
            assert torch.equal(want_p[name], before[name]), name
            continue
        moved = (want_p[name] - before[name]).norm()
        err = (p - want_p[name]).norm()
        assert moved > 0 and err <= STEP_TOL[net] * moved, (
            name, float(err), float(moved))
    want_m = from_jax_opt_state(new_opt, mask)
    assert want_m["step"] == 6 and set(want_m["momentum"]) == \
        set(state.opt.trace)
    for name, t in state.opt.trace.items():
        ref = want_m["momentum"][name]
        err = (t - ref).norm()
        assert err <= STEP_TOL[net] * ref.norm(), (name, float(err))
    back = to_jax_opt_state(state.opt.state_dict(),
                            state.det.backbone.state_dict(), new_opt)
    assert jax.tree.structure(back) == jax.tree.structure(new_opt)


@pytest.mark.parametrize("net", NETS)
def test_backward_matches_jax_in_float64(net):
    """The backward itself, free of f32 rounding: the gradient of
    sum(preds * G) over every trainable leaf, JAX in float64 against the
    port in float64, to 1e-12 of each leaf's largest gradient, on one
    48x48 image (float64 convs are slow on the CPU)."""
    jdet, tree, mask = _jax_net(net)
    cfg = st.tiny_test_config(net, image_width=48, image_height=48)
    x = _images(np.random.RandomState(2), cfg, b=1).astype(np.float64)
    g = np.random.RandomState(3).randn(1, cfg.grid_h, cfg.grid_w, 72)
    jax.config.update("jax_enable_x64", True)
    try:
        trainable, frozen = partition_params(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree), mask)
        grads = jax.grad(lambda tp: jnp.sum(jdet.backbone.apply(
            merge_params(tp, frozen), jnp.asarray(x), jdet.cfg) * g))(
                trainable)
        want = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
            keys = [k.key for k in path]
            want[".".join(keys[:-1] + [
                "weight" if keys[-1] == "kernel" else keys[-1]])] = \
                np.array(leaf)
    finally:
        jax.config.update("jax_enable_x64", False)
    det = _port(net, tree).double()
    (det.backbone(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    got = {n: p.grad for n, p in det.backbone.named_parameters()
           if p.requires_grad}
    assert set(got) == set(want)
    for name, grad in got.items():
        w = torch.from_numpy(want[name])
        if grad.dim() == 4:
            w = w.permute(3, 2, 0, 1)
        assert (grad - w).abs().max() <= 1e-12 * w.abs().max(), name


def _jax_routed_calls(net):
    """(kh, C, O) of the JAX package's Pallas filter-grad calls in its
    routed mode, traced abstractly on the gradient of the trainable
    subtree (as its train step takes it)."""
    import squeezedet_tpu.ops.filter_grad as jfg
    jdet, tree, mask = _jax_net(net)
    trainable, frozen = partition_params(jax.tree.map(jnp.asarray, tree),
                                         mask)
    x = jnp.zeros((2, jdet.cfg.image_height, jdet.cfg.image_width, 3))
    calls, real = [], jfg.filter_grad

    def spy(x, g, kh, kw, **_):
        calls.append((kh, x.shape[-1], g.shape[-1]))
        return jnp.zeros((kh, kw, x.shape[-1], g.shape[-1]), jnp.float32)

    jfg.filter_grad = spy
    try:
        JL.set_pallas_filter_grad("interpret")
        jax.eval_shape(jax.grad(lambda tp: jdet.forward(
            merge_params(tp, frozen), x).sum()), trainable)
    finally:
        JL.set_pallas_filter_grad(False)
        jfg.filter_grad = real
    return calls


@pytest.mark.parametrize("net", NETS)
def test_k2_routed_step_equals_autograd(net):
    """Filter-grad mode True against False from the same state: K2 (its
    plain version here) takes the weight gradients of exactly the convs
    the JAX package routes (20 / 10 / 1 calls), and the two steps agree:
    loss terms to rtol 1e-6, params and momentum within 1e-3 of each
    leaf's update plus 1e-9 (f32 sums in other orders)."""
    tree, opt_state, batch, _, _, _ = _jax_step(net)
    plain = _port_state(net, tree, opt_state)
    routed = _port_state(net, tree, opt_state)
    before = {n: p.detach().clone()
              for n, p in plain.det.backbone.state_dict().items()}
    want, _ = _run_step(plain, batch, False)
    got, calls = _run_step(routed, batch, True)
    assert len(calls) == K2_CALLS[net]
    assert sorted(calls) == sorted(_jax_routed_calls(net))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want_p = plain.det.backbone.state_dict()
    for name, p in routed.det.backbone.state_dict().items():
        moved = (want_p[name] - before[name]).abs().max()
        err = (p - want_p[name]).abs().max()
        assert err <= 1e-3 * moved + 1e-9, (name, float(err))
    for name, t in routed.opt.trace.items():
        ref = plain.opt.trace[name]
        assert (t - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-9, name


def _meta_routed(net, mode):
    """(kh, C, O, H, W) of the convs routed to K2 by one backward at the
    net's full config, run on the meta device (shapes only)."""
    det = st.get_model(net, st.config_for_net(net), device="meta")
    cfg = det.cfg
    calls = []
    real = fg.filter_grad

    def spy(x, dy, kh, kw):
        calls.append((kh, x.shape[-1], dy.shape[-1]) + tuple(x.shape[1:3]))
        return torch.empty((kh, kw, x.shape[-1], dy.shape[-1]),
                           device=x.device)
    fg.filter_grad = spy
    try:
        TL.set_filter_grad(mode)
        x = torch.empty((cfg.batch_size, cfg.image_height, cfg.image_width,
                         3), device="meta")
        for dtype in (torch.float32, torch.bfloat16):
            det.backbone(x.to(dtype)).float().sum().backward()
    finally:
        TL.set_filter_grad(False)
        fg.filter_grad = real
    return calls


# (calls, kh, C, O, H, W) routed to K2 by one backward in mode True at
# the published geometry (chip_smoke.py K2_BACKBONE_SHAPES times them)
FULL_ROUTED = {
    "squeezeDet+": [(2, 1, 128, 192, 45, 153), (2, 1, 128, 288, 45, 153),
                    (1, 1, 384, 256, 45, 153), (1, 3, 384, 256, 45, 153),
                    (6, 1, 256, 384, 22, 76), (3, 1, 384, 256, 22, 76),
                    (3, 3, 384, 256, 22, 76), (2, 3, 256, 72, 22, 76)],
    "vgg16": [(1, 3, 128, 256, 94, 311), (2, 3, 256, 256, 94, 311),
              (1, 3, 256, 512, 47, 156), (2, 3, 512, 512, 47, 156),
              (3, 3, 512, 512, 24, 78), (1, 3, 512, 72, 24, 78)],
    "resnet50": [(1, 3, 1024, 72, 24, 78)],
}


@pytest.mark.parametrize("net", NETS)
def test_full_geometry_routing(net):
    """At the published geometry, in f32 and bf16: mode True routes
    20 / 10 / 1 calls per backward at the shapes of FULL_ROUTED, and
    "1x1" (what --pallas_grads sets) routes none: VGG16 has no 1x1 conv,
    ResNet's are conv_bn, and squeezeDet+'s 128/256-channel halves sit at
    45x153 and 22x76, where H*W % 16 != 0."""
    want = sorted(shape for calls, *shape in FULL_ROUTED[net]
                  for _ in range(2 * calls))
    assert sum(c for c, *_ in FULL_ROUTED[net]) == K2_CALLS[net]
    assert sorted(_meta_routed(net, True)) == [tuple(s) for s in want]
    assert _meta_routed(net, "1x1") == []


# Per-layer parameter counts, grids and head widths of the published
# configs (tests/test_models.py:16-29).
_EXPECT_GRID = {"squeezeDet+": (22, 76), "vgg16": (24, 78),
                "resnet50": (24, 78)}


@functools.lru_cache(maxsize=None)
def _jax_full(net):
    cfg = config_for_net(net).replace(load_pretrained_model=False)
    _, mask, tracer = jax_get_model(net, cfg).init(jax.random.key(0))
    return mask, tracer


@pytest.mark.parametrize("net", NETS)
def test_structure_at_full_size(net):
    """Grid, head channels 72, per-layer parameter, activation and FLOP
    counts equal to the JAX tracer's; the preds' shape on the meta
    device."""
    _, jtracer = _jax_full(net)
    det = st.get_model(net, st.config_for_net(net), device="meta")
    cfg, tracer = det.cfg, det.tracer
    assert (tracer.height, tracer.width) == _EXPECT_GRID[net] == \
        (cfg.grid_h, cfg.grid_w)
    assert tracer.channels == cfg.head_channels == 72
    assert tracer.model_size_counter == jtracer.model_size_counter
    assert tracer.activation_counter == jtracer.activation_counter
    assert tracer.flop_counter == jtracer.flop_counter
    x = torch.empty((1, cfg.image_height, cfg.image_width, 3), device="meta")
    assert tuple(det(x).shape) == (1,) + _EXPECT_GRID[net] + (72,)


@pytest.mark.parametrize("net", NETS)
def test_trainable_mask_matches_jax(net):
    """The port's mask (every state_dict entry) equals the JAX package's
    leaf by leaf: conv1_x/conv2_x frozen in VGG16, conv1/res2/res3 frozen
    and res4 trained in ResNet50 (gamma and beta with their layer), the
    batch-norm statistics never trained, conv1 frozen in squeezeDet+."""
    jmask, _ = _jax_full(net)
    det = st.get_model(net, st.tiny_test_config(net), device="cpu")
    got = det.trainable_mask()
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jmask):
        keys = [k.key for k in path]
        want[".".join(keys[:-1] + [
            "weight" if keys[-1] == "kernel" else keys[-1]])] = bool(leaf)
    assert got == want
    assert got["conv1.weight" if net != "vgg16" else "conv1_1.weight"] is \
        False
    if net == "vgg16":
        assert not got["conv2_2.weight"] and got["conv3_1.weight"]
    if net == "resnet50":
        assert not got["res2a.branch2.branch2a.weight"]
        assert not got["res3d.branch2.branch2c.gamma"]
        assert got["res4a.branch1.weight"] and got["res4f.branch2.branch2b.beta"]
        assert not got["res4a.branch1.mean"] and not got["res4f.branch2."
                                                         "branch2c.var"]
        # the statistics are buffers: in state_dict, never optimised
        names = dict(det.backbone.named_parameters())
        assert "res4a.branch1.mean" not in names
        assert "res4a.branch1.mean" in det.backbone.state_dict()


def test_concat_free_squeezedet_plus_matches_naive():
    """The concat-free squeezeDet+ chain (VALID pools on the halves)
    equals the naive concat formulation: fire as one concatenated tensor,
    pooled after the concat, to 1e-5."""
    _, tree, _ = _jax_net("squeezeDet+")
    det = _port("squeezeDet+", tree)
    bb = det.backbone
    from squeezedet_torch.models.squeezedet_plus import _FIRES, _POOL_AFTER
    x = torch.from_numpy(_images(np.random.RandomState(4), det.cfg))
    with torch.no_grad():
        y = TL.max_pool(TL.conv2d(bb.conv1, x, 2, "VALID"), 3, 2, "VALID")
        for name, _, _, _ in _FIRES:
            fire = getattr(bb, name)
            sq = TL.conv2d(fire.squeeze1x1, y, 1)
            y = torch.cat([TL.conv2d(fire.expand1x1, sq, 1),
                           TL.conv2d(fire.expand3x3, sq, 1)], dim=-1)
            if name in _POOL_AFTER:
                y = TL.max_pool(y, 3, 2, "VALID")
        want = TL.conv2d(bb.conv12, y, 1, relu=False)
        got = bb(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_conv_bn_matches_jax(rng):
    """conv_bn against the JAX layer, stride 1 and 2, with and without
    bias and relu, f32 to 1e-5 and bf16 to 2 bf16 ulps of the largest
    value (the affine's terms round to bf16 in the same places)."""
    for stride, with_bias, relu in ((1, False, True), (2, True, True),
                                    (1, True, False)):
        kern = (rng.randn(3, 3, 6, 8) * 0.3).astype(np.float32)
        p = {"kernel": kern, "gamma": rng.uniform(0.5, 1.5, 8),
             "beta": rng.randn(8) * 0.1, "mean": rng.randn(8) * 0.2,
             "var": rng.uniform(0.3, 3.0, 8)}
        if with_bias:
            p["bias"] = rng.randn(8) * 0.1
        p = {k: np.asarray(v, np.float32) for k, v in p.items()}
        layer = TL.ConvBN(torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                          torch.from_numpy(p["bias"]) if with_bias else None,
                          8)
        layer.load_state_dict({k[len("l."):]: v for k, v in
                               from_jax_params({"l": p}).items()})
        x = rng.randn(2, 11, 9, 6).astype(np.float32)
        for dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
            want = np.asarray(JL.conv_bn(
                jax.tree.map(jnp.asarray, p), jnp.asarray(x).astype(jdt),
                stride, relu=relu)).astype(np.float32)
            with torch.no_grad():
                got = TL.conv_bn(layer, torch.from_numpy(x).to(dtype), stride,
                                 relu=relu).float().numpy()
            assert got.shape == want.shape
            tol = 1e-5 if dtype == torch.float32 else \
                2 * 2.0 ** -8 * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_resnet_bridge_round_trip_and_opt_state():
    """A ResNet tree, the batch-norm leaves included, goes JAX -> torch
    -> JAX bit-identically; mean and var land in buffers; the JAX
    optimizer state (with its always-zero mean/var trace leaves) loads
    into the port's optimizer and maps back onto the chain."""
    jdet, tree, mask = _jax_net("resnet50")
    state = from_jax_params(tree)
    det = st.get_model("resnet50", st.tiny_test_config("resnet50"),
                       device="cpu")
    det.backbone.load_state_dict(state)  # strict: every name maps
    back = to_jax_params(det.backbone.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert torch.equal(det.backbone.res3b.branch2.branch2b.var,
                       torch.from_numpy(tree["res3b"]["branch2"]["branch2b"]
                                        ["var"]))
    assert tuple(state["conv1.weight"].shape) == (64, 3, 7, 7)
    assert "conv1.bias" in state and "res2a.branch1.bias" not in state

    tx = jax_build_optimizer(jdet.cfg, mask)
    opt_state = tx.init(jax.tree.map(jnp.asarray, tree))
    opt = build_optimizer(det.cfg, det)
    loaded = from_jax_opt_state(opt_state, det.trainable_mask())
    opt.load_state_dict(loaded)
    assert "res4a.branch1.gamma" in loaded["momentum"]
    assert not any(n.endswith((".mean", ".var")) for n in loaded["momentum"])
    again = to_jax_opt_state(opt.state_dict(), det.backbone.state_dict(),
                             opt_state)
    assert jax.tree.structure(again) == jax.tree.structure(opt_state)


@pytest.mark.parametrize("net", NETS)
def test_caffe_pickle_loads_as_in_jax(net, capsys):
    """One caffe pickle (ResNet's with its bn*/scale* entries) gives the
    same parameters through Detector.load_pretrained as through the JAX
    det.init(..., pretrained=...), and neither leaves an entry unread."""
    jdet, tree, _ = _jax_net(net)
    pickle = pickle_from_jax_params(tree)
    if net == "resnet50":
        assert {"conv1", "bn_conv1", "scale_conv1", "res2a_branch1",
                "bn2a_branch1", "scale4f_branch2c", "conv5"} <= set(pickle)
        assert len(pickle["conv1"]) == 2 and len(pickle["res2a_branch1"]) == 1
    want, _, _ = jdet.init(jax.random.key(5), pretrained=pickle)
    det = st.get_model(net, st.tiny_test_config(net), device="cpu")
    det.load_pretrained(pickle)
    out = capsys.readouterr().out
    assert "WARNING" not in out and "Cannot find" not in out
    got = to_jax_params(det.backbone.state_dict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(g, np.asarray(w))


def test_pretrained_gaps_are_reported(capsys):
    """A pickle without a layer's batch-norm entry keeps that layer's
    random init and says so; an entry of another shape too; entries that
    matched no layer are listed."""
    _, tree, _ = _jax_net("resnet50")
    pickle = pickle_from_jax_params(tree)
    del pickle["bn2b_branch2a"]
    pickle["res3a_branch1"] = [np.zeros((4, 4, 1, 1), np.float32)]
    pickle["res9z_branch1"] = [np.zeros((1,), np.float32)]
    det = st.get_model("resnet50", st.tiny_test_config("resnet50"),
                       device="cpu")
    seeded = {k: v.clone() for k, v in det.backbone.state_dict().items()}
    det.load_pretrained(pickle)
    out = capsys.readouterr().out
    assert "Cannot find bn2b_branch2a" in out
    assert "res3a_branch1 does not match" in out
    assert "res9z_branch1" in out and "matched no model layer" in out
    sd = det.backbone.state_dict()
    assert torch.equal(sd["res2b.branch2.branch2a.weight"],
                       seeded["res2b.branch2.branch2a.weight"])
    assert torch.equal(sd["res3a.branch1.gamma"], seeded["res3a.branch1.gamma"])
    assert not torch.equal(sd["res2a.branch1.var"], seeded["res2a.branch1.var"])
