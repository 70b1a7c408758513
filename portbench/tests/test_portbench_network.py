"""A configuration brings its own reference network
(``portbench.reference.network``): the two configurations' readings as
they stood before the resolver; a toy bottleneck network with batch
norm, which a layer list cannot write, reached at every call site and
run through both runners; and VGG16, a conv-only layer list, through
both runners."""

import hashlib
import sys

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from portbench import frozen, program, run, traffic
from portbench.reference import network, train as ref_train
from portbench.tests import tiny, toy_bottleneck
from portbench.tests.test_portbench_reference import (
    TRAIN_1, _runner, scores_as_the_reference, trains_as_the_reference)

BIG = 2 ** 31 + 12345


def _cfg(name):
    return run.load_json("portbench", "configs", name + ".json")


def digest(tensors):
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# read from the harness before configurations could name their network
PINNED = {
    "squeezedet_kitti": dict(
        flops=10_649_089_152,
        routed=[(1, 256, 32, 48, 156), (1, 256, 48, 24, 78),
                (1, 512, 64, 24, 78), (1, 512, 96, 24, 78),
                (1, 768, 96, 24, 78)],
        digests={0: "4122d1d395b44a70baee8491c92ba73d"
                    "cdd96e028e0167c5b5ccefe17fb5b6b0",
                 BIG: "fafcec1ef88233197f97f757e385b98f"
                      "99a09d5c333857e30137893596d182c3"}),
    "squeezedetplus_kitti": dict(
        flops=77_246_240_640, routed=[],
        digests={0: "648796f6392c86bd82b49995f3817844"
                    "e2ca31b24ea5bea45128baad7ada70db",
                 BIG: "2d20ed8f64773d6b6189b128f4eb08f3"
                      "48a56afab9b2b0e651d0c2d9ca42d4d8"}),
}
READINGS = ["flops", "routed", "digest 0", "digest big"]


@pytest.mark.parametrize("reading", READINGS)
@pytest.mark.parametrize("name", sorted(PINNED))
def test_readings_as_before(name, reading):
    """FLOP, the "1x1" route's convs, and the seeded weights (the probe's
    head scaling included, at the tiny size, on the CPU) of each
    configuration, through the resolver, as the layer list gave them."""
    cfg, pin = _cfg(name), PINNED[name]
    assert "reference" not in cfg and network(cfg).__name__ == \
        "portbench.reference.model"
    if reading == "flops":
        assert frozen.forward_flops(cfg) == pin["flops"]
    elif reading == "routed":
        assert network(cfg).k2_routed(cfg) == pin["routed"]
    else:
        seed = 0 if reading == "digest 0" else BIG
        weights = traffic.model_weights(seed, tiny.tiny_config(cfg), "cpu")
        assert digest(weights) == pin["digests"][seed]


@pytest.mark.parametrize("name", ["", "a.b", "../x", "model-2", 3])
def test_resolver_refuses_what_is_no_module_name(name):
    with pytest.raises(ValueError):
        network({"name": "x", "reference": name})


# --- the toy bottleneck ------------------------------------------------------

TOY = "portbench.reference.toy_bottleneck"


def toy_config():
    """squeezeDet's tiny configuration (whose program config the toy's
    stride of 16 fits) with the toy as its network."""
    cfg = tiny.tiny_config(_cfg("squeezedet_kitti"))
    del cfg["layers"], cfg["params"]
    cfg.update(name="toy_bottleneck", reference="toy_bottleneck",
               batch_norm_epsilon=1e-5,
               init={"gain": {"stem": 0.01}, "std": {"head": 0.1},
                     "head_rms": 1.0})
    return cfg


class ToyBackbone(nn.Module):
    """The toy written with the program's layers: ``ConvBN`` (frozen
    statistics as buffers), ``conv_bn``, ``max_pool``, ``dropout`` and
    ``conv2d``."""

    def __init__(self, pcfg, device):
        from squeezedet_torch.models import layers as L
        super().__init__()
        self.eps, self.keep_prob = pcfg.batch_norm_epsilon, pcfg.keep_prob

        def conv_bn(c, o, k, freeze=False):
            return L.ConvBN(torch.zeros(o, c, k, k, device=device), None, o,
                            freeze=freeze)
        s, m, o = toy_bottleneck.STEM, toy_bottleneck.MID, toy_bottleneck.OUT
        self.stem = conv_bn(3, s, 5, freeze=True)
        self.res = nn.Module()
        self.res.branch1 = conv_bn(s, o, 1)
        self.res.branch2 = nn.Module()
        for part, (c, f, k) in zip(("branch2a", "branch2b", "branch2c"),
                                   ((s, m, 1), (m, m, 3), (m, o, 1))):
            self.res.branch2.add_module(part, conv_bn(c, f, k))
        heads = pcfg.anchor_per_grid * (pcfg.classes + 5)
        self.head = L.Conv(torch.zeros(heads, o, 3, 3, device=device),
                           torch.zeros(heads, device=device))

    def forward(self, images, *, train=False, generator=None, tape=None):
        from squeezedet_torch.models import layers as L
        eps, kp = self.eps, self.keep_prob
        x = L.conv_bn(self.stem, images, 4, eps=eps)
        x = L.dropout(L.max_pool(x, 3, 2, "SAME"), kp, generator, train)
        b2 = self.res.branch2
        y = L.conv_bn(b2.branch2a, x, 2, eps=eps)
        y = L.conv_bn(b2.branch2b, y, 1, eps=eps)
        y = L.conv_bn(b2.branch2c, y, 1, relu=False, eps=eps)
        x = F.relu(L.conv_bn(self.res.branch1, x, 2, relu=False, eps=eps)
                   + y)
        half = x.shape[-1] // 2
        x = torch.cat([L.dropout(x[..., :half], kp, generator, train),
                       L.dropout(x[..., half:], kp, generator, train)], -1)
        return L.conv2d(self.head, x, 1, relu=False)


def toy_detector(pcfg, device="cpu"):
    from squeezedet_torch.models import Detector
    return Detector(pcfg, ToyBackbone(pcfg, device), "toy",
                    device=device).eval()


@pytest.fixture
def toy(monkeypatch):
    """The toy's configuration, its module reachable by the resolver, and
    the program's ``get_model`` building the toy."""
    import squeezedet_torch.models
    monkeypatch.setitem(sys.modules, TOY, toy_bottleneck)
    monkeypatch.setattr(squeezedet_torch.models, "get_model",
                        lambda net, pcfg, device, generator=None:
                        toy_detector(pcfg, device))
    return toy_config()


def test_resolver_reaches_the_named_module(toy):
    assert network(toy) is toy_bottleneck


def test_seeded_draw_fills_the_buffers(toy):
    net = network(toy)
    a = net.draw(BIG, toy, "cpu")
    buffers = net.buffer_shapes(toy)
    assert len(buffers) == 10
    assert set(a) == set(net.param_shapes(toy)) | set(buffers)
    for name, shape in buffers.items():
        assert tuple(a[name].shape) == shape
    means = torch.cat([a[n] for n in buffers if n.endswith(".mean")])
    variances = torch.cat([a[n] for n in buffers if n.endswith(".var")])
    assert means.abs().min() > 0 and variances.min() > 0
    assert not torch.allclose(variances, torch.ones_like(variances))
    b, c = net.draw(BIG, toy, "cpu"), net.draw(BIG + 1, toy, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["stem.mean"], c["stem.mean"])
    # the statistics' own draw leaves the kernels' as he_weights gives it
    kernels = {n: s for n, s in net.param_shapes(toy).items()
               if n.endswith((".weight", ".bias"))}
    he = traffic.he_weights(BIG, kernels, toy["init"], "cpu")
    assert all(torch.equal(a[n], he[n]) for n in kernels)


def test_load_copies_buffers(toy):
    net = network(toy)
    weights = traffic.model_weights(BIG, toy, "cpu")
    det = program.detector(toy, 2, weights, "cpu")
    held = dict(det.backbone.named_buffers())
    for name in net.buffer_shapes(toy):
        assert torch.equal(held[name], weights[name])
    for name, p in det.backbone.named_parameters():
        assert torch.equal(p, weights[name])


@pytest.mark.parametrize("fault", ["missing", "misshaped", "not drawn"])
def test_load_refuses_a_buffer(toy, fault):
    net = network(toy)
    weights = net.draw(BIG, toy, "cpu")
    det = toy_detector(program.program_config(toy, 2))
    branch = det.backbone.res.branch1
    if fault == "missing":
        del branch._buffers["var"]
    elif fault == "misshaped":
        branch.var = torch.ones(3)
    else:
        del weights["res.branch1.var"]
    before = {n: t.clone() for n, t in det.backbone.state_dict().items()}
    with pytest.raises(ValueError, match=r"res\.branch1\.var"):
        program.load(det, weights, net.buffer_shapes(toy))
    # nothing copied
    after = det.backbone.state_dict()
    assert all(torch.equal(before[n], after[n]) for n in before)


def test_load_refuses_parameters_that_differ(toy):
    weights = network(toy).draw(BIG, toy, "cpu")
    det = toy_detector(program.program_config(toy, 2))
    with pytest.raises(ValueError, match="parameter names differ"):
        program.load(det, weights, ())  # the buffers taken as parameters


def test_forward_flops_counts_its_convs(toy):
    # (in, filters, size, out height, out width, relu) at 128 x 64
    convs = [(3, 16, 5, 16, 32, True), (16, 32, 1, 4, 8, False),
             (16, 8, 1, 4, 8, True), (8, 8, 3, 4, 8, True),
             (8, 32, 1, 4, 8, False), (32, 72, 3, 4, 8, False)]
    assert frozen.forward_flops(toy) == sum(frozen.conv_flops(*c)
                                            for c in convs)
    assert network(toy).grid(toy) == (4, 8)


def test_head_scaling_uses_its_head(toy):
    net = network(toy)
    drawn = net.draw(BIG, toy, "cpu")
    scaled = traffic.model_weights(BIG, toy, "cpu")
    gain = float(scaled["head.weight"].flatten()[0]
                 / drawn["head.weight"].flatten()[0])
    assert abs(gain - 1) > 0.01
    for name in drawn:
        want = drawn[name] * gain if name.startswith("head.") else drawn[name]
        assert torch.allclose(scaled[name], want, rtol=1e-6, atol=0), name
    frame = traffic.uint8_images(BIG, "probe_frame", (1, 64, 128, 3),
                                 "cpu").float()
    out = net.forward(toy, scaled, frame - torch.tensor(toy["bgr_means"]))
    assert float(out.pow(2).mean().sqrt()) == pytest.approx(1.0, rel=0.01)


def _program_masks(det, images, gen_state):
    """The program's keep masks of one training forward, in draw order,
    and its output."""
    from squeezedet_torch.models import layers
    drawn, dropout = [], layers.dropout

    def read(x, keep_prob, generator, train):
        m = dropout(torch.ones_like(x), keep_prob, generator, train)
        drawn.append(m != 0)
        return x * m
    gen = torch.Generator()
    gen.set_state(gen_state)
    layers.dropout = read
    try:
        with torch.no_grad():
            out = det.backbone(images, train=True, generator=gen)
    finally:
        layers.dropout = dropout
    return drawn, out


def test_draw_masks_follow_its_dropout_parts(toy):
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    masks = ref_train.draw_masks(toy, gen, 2)
    assert [tuple(m.shape) for m in masks] == [(2, 8, 16, 16),
                                               (2, 4, 8, 32)]
    weights = traffic.model_weights(BIG, toy, "cpu")
    det = program.detector(toy, 2, weights, "cpu")
    images = torch.randn(2, 64, 128, 3) * 50
    drawn, out = _program_masks(det, images, state)
    assert len(drawn) == 3
    assert torch.equal(masks[0], drawn[0])
    assert torch.equal(masks[1], torch.cat(drawn[1:], dim=-1))
    # the program with those masks is the reference with them
    ref = network(toy).forward(toy, weights, images, masks)
    assert torch.allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_k2_reads_nothing_where_no_conv_is_routed(toy):
    from types import SimpleNamespace
    from portbench.trace import Summary
    reader = run.reader("k2_roofline.train")
    assert network(toy).k2_routed(toy) == []
    ctx = SimpleNamespace(
        cfg=toy, mix={"batch": 2}, window={"steps": 2},
        trace=Summary([("filter_grad_wgmma", 0, 1000, "kernel")], [], 0.01,
                      1))
    assert reader.read(ctx, "k2_roofline.train") is None


def test_toy_scores_as_the_reference(toy):
    scores_as_the_reference(_runner("sqdet.score.b128", tiny.SCORE, 11,
                                    toy))


@pytest.mark.parametrize("seed", [12, 13])
def test_toy_trains_as_the_reference(toy, seed):
    d = _runner("sqdet.train.b20k8", TRAIN_1, seed, toy)
    trains_as_the_reference(d)
    # its frozen stem stays out of the optimizer, its buffers are no leaf
    assert set(d.first_grads) == set(network(toy).param_shapes(toy)) - \
        network(toy).frozen_params(toy)


# --- VGG16: a conv-only layer list -------------------------------------------

def vgg16_config():
    """VGG16 + ConvDet (BichenWuUCB/squeezeDet ``src/nets/vgg16_convDet.py``)
    as a layer list at the tiny size: 13 3x3 SAME convs, blocks 1 and 2
    frozen, a 2x2 stride-2 SAME max-pool after blocks 1-4, dropout, the
    head ``conv6``."""
    layers = []
    for block, (n, filters) in enumerate([(2, 64), (2, 128), (3, 256),
                                          (3, 512), (3, 512)], 1):
        for i in range(1, n + 1):
            layers.append({"conv": "conv{}_{}".format(block, i),
                           "filters": filters, "size": 3, "stride": 1,
                           "padding": "SAME", "frozen": block <= 2})
        if block <= 4:
            layers.append({"pool": "pool{}".format(block), "size": 2,
                           "stride": 2, "padding": "SAME"})
    layers += [{"dropout": "drop6"},
               {"conv": "conv6", "filters": 72, "size": 3, "stride": 1,
                "padding": "SAME", "relu": False}]
    cfg = tiny.tiny_config(_cfg("squeezedet_kitti"))
    cfg.update(name="vgg16_kitti", net="vgg16", layers=layers,
               init={"gain": {"conv1_1": 0.001}, "std": {"conv6": 0.1},
                     "head_rms": 1.0})
    return cfg


def test_vgg16_layer_list():
    cfg = vgg16_config()
    net = network(cfg)
    assert net.grid(cfg) == (4, 8)
    assert net.dropout_parts(cfg) == [(4, 8, (512,))]
    assert sum(t.numel() for t in net.draw(0, cfg, "cpu").values()) == \
        14_714_688 + 512 * 9 * 72 + 72


def test_vgg16_scores_as_the_reference():
    scores_as_the_reference(_runner("sqdet.score.b128", tiny.SCORE, 11,
                                    vgg16_config()))


def test_vgg16_trains_as_the_reference():
    trains_as_the_reference(_runner("sqdet.train.b20k8", TRAIN_1, 12,
                                    vgg16_config()))
