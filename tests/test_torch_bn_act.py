"""K4, ResNet's conv + batch-norm epilogue in one pass (``ops/bn_act.py``,
``csrc/bn_act.cu``), and its routing from ``layers.conv_bn`` and
``layers.join``.

On the CPU: the plain version equals the torch ops it replaced bit for
bit in each operand form, the routing predicate takes and refuses the
right calls (fake CUDA tensors), a spatial tile reaches the wrapper as a
whole map does and an int8 layer never does, and ResNet50's forward is
the one before K4.  On the card (``cuda``-marked): the kernel against
the plain version bit for bit at every conv + batch-norm and join shape
of ``resnet50_kitti``, a spatial mesh's tiles launching it, the launches
of a scoring forward and of a captured train dispatch, and a train step
with K4 against one without.  No JAX here: the card runs this
file.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import squeezedet_torch as st
from squeezedet_torch.models import layers as L
from squeezedet_torch.ops import _cuda
from squeezedet_torch.ops import bn_act as K
from torch_threads import one_thread  # noqa: F401

EPS = 1e-5
DTYPES = [torch.float32, torch.bfloat16]
# operand forms: (bias, relu, shortcut): None, "identity" or "projection";
# each but "affine" (no ReLU: the plain version's alone) is one of K4's
FORMS = {"bias_relu": (True, True, None), "relu": (False, True, None),
         "affine": (False, False, None),
         "identity_join": (False, True, "identity"),
         "projection_join": (False, True, "projection")}


def _layer(c, seed, bias=False, device="cpu"):
    """A batch norm's f32 vectors (and a conv bias) drawn as the
    benchmark's ResNet50 draws them: gamma exp(0.2 z), beta 0.1 z, mean
    0.1 z, var exp(0.4 z); a few channels with beta -0 and mean 0, so
    that a -0 input stays -0 through the affine."""
    rs = np.random.RandomState(seed)
    z = lambda: rs.randn(c).astype(np.float32)  # noqa: E731
    bn = L.ConvBN(torch.zeros(c, 1, 1, 1), torch.from_numpy(z() * 0.1)
                  if bias else None, c)
    with torch.no_grad():
        bn.gamma.copy_(torch.from_numpy(np.exp(0.2 * z())))
        bn.beta.copy_(torch.from_numpy(0.1 * z()))
        bn.mean.copy_(torch.from_numpy(0.1 * z()))
        bn.var.copy_(torch.from_numpy(np.exp(0.4 * z())))
        bn.beta[:3] = -0.0
        bn.mean[:3] = 0.0
    return bn.to(device)


def _map(b, c, h, w, dtype, seed, device="cpu"):
    """A raw conv output [B, C, H, W] in channels_last memory, with -0s,
    zeros, a NaN and infinities planted."""
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(b, h, w, c, generator=g) * 3).to(dtype)
    flat = y.view(-1)
    flat[:7] = torch.tensor([-0.0, 0.0, float("nan"), float("inf"),
                             -float("inf"), -0.0, 1e-3]).to(dtype)
    return y.to(device).permute(0, 3, 1, 2)


def _before(y, layer, eps, relu, shortcut=None, shortcut_layer=None):
    """The arithmetic that K4 replaced, as ``layers.conv_bn`` and
    ``ResNet50._block`` wrote it before: the bias add, the affine with
    f32 scale and shift cast to y's dtype, ReLU; the join
    ``relu(shortcut + branch2c)``."""
    def bn(y, layer):
        dev, dt = y.device, y.dtype
        if layer.bias is not None:
            y = y + layer.bias.to(dev, dt).view(1, -1, 1, 1)
        inv = layer.gamma * torch.rsqrt(layer.var + eps)
        shift = layer.beta - layer.mean * inv
        return y * inv.to(dev, dt).view(1, -1, 1, 1) + \
            shift.to(dev, dt).view(1, -1, 1, 1)
    t = bn(y, layer)
    if shortcut is None:
        return F.relu(t) if relu else t
    s = shortcut if shortcut_layer is None else bn(shortcut, shortcut_layer)
    return F.relu(s + t)


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def _operands(form, dtype, shape=(2, 16, 5, 7), device="cpu", seed=0):
    bias, relu, kind = FORMS[form]
    b, c, h, w = shape
    y = _map(b, c, h, w, dtype, seed, device)
    layer = _layer(c, seed + 1, bias, device)
    kw = {}
    if kind is not None:
        kw["shortcut"] = _map(b, c, h, w, dtype, seed + 2, device)
    if kind == "projection":
        kw["shortcut_layer"] = _layer(c, seed + 3, False, device)
    return y, layer, relu, kw


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_version_is_the_arithmetic_it_replaced(form, dtype):
    y, layer, relu, kw = _operands(form, dtype)
    before = K.LAUNCHES
    got = K.bn_act(y.clone(), layer, EPS, relu=relu, **kw)
    want = _before(y, layer, EPS, relu, **kw)
    assert K.LAUNCHES == before
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))


def _fits(change=None, dtype=torch.bfloat16, form="projection_join",
          shape=(2, 16, 5, 7), grad=True, frozen=True):
    """The kernel's operand test (``bn_act.fits``) on a call of ``form``,
    frozen or not, after ``change`` (args -> args)."""
    y, layer, relu, kw = _operands(form, dtype, shape)
    args = dict(y=y, layer=layer, relu=relu, **kw)
    if frozen:
        for lay in (layer, kw.get("shortcut_layer")):
            for p in lay.parameters() if lay is not None else ():
                p.requires_grad_(False)
    if change is not None:
        args = change(args)
    with torch.set_grad_enabled(grad):
        return K.fits(args["y"], args["layer"], relu=args["relu"],
                      shortcut=args.get("shortcut"),
                      shortcut_layer=args.get("shortcut_layer"))


def _frozen_layer(c, dtype=torch.float32, bias=False):
    layer = _layer(c, 9, bias).to(dtype)
    for p in layer.parameters():
        p.requires_grad_(False)
    return layer


REFUSED = {
    "float16": lambda a: dict(a, y=a["y"].half(),
                              shortcut=a["shortcut"].half()),
    "not_channels_last": lambda a: dict(a, y=a["y"].contiguous()),
    "shortcut_not_channels_last":
        lambda a: dict(a, shortcut=a["shortcut"].contiguous()),
    "shortcut_shape": lambda a: dict(a, shortcut=a["shortcut"][:1]),
    "not_16_byte_aligned": lambda a: dict(
        a, y=torch.empty(2 * 16 * 5 * 7 + 4, dtype=torch.bfloat16)[4:]
        .view(2, 5, 7, 16).permute(0, 3, 1, 2)),
    "projection_with_bias": lambda a: dict(
        a, shortcut_layer=_frozen_layer(16, bias=True)),
    "bias_with_a_shortcut": lambda a: dict(
        a, layer=_frozen_layer(16, bias=True)),
    "no_relu": lambda a: dict(a, relu=False),
    "f64_vectors": lambda a: dict(
        a, layer=_frozen_layer(16, torch.float64)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("form", list(FORMS))
def test_k4_fits_frozen_channels_last_maps(form, dtype):
    """Each of the kernel's forms fits, in training (frozen layers) and
    in scoring; the affine without ReLU is the plain version's alone."""
    kernel_form = form != "affine"
    assert _fits(None, dtype, form) == kernel_form
    assert _fits(None, dtype, form, grad=False, frozen=False) == kernel_form


@pytest.mark.parametrize("why", list(REFUSED))
def test_k4_refuses(why):
    assert _fits(None, grad=False)
    assert not _fits(REFUSED[why], grad=False)


def test_k4_refuses_a_call_autograd_sees_through():
    assert not _fits(None, frozen=False)  # gamma and beta train (res4)
    assert not _fits(lambda a: dict(a, y=a["y"].requires_grad_()),
                     form="relu")


def test_k4_refuses_channels_not_a_multiple_of_8():
    assert not _fits(None, shape=(2, 12, 5, 7), grad=False)


def test_k4_refuses_cpu_maps_that_fit():
    y, layer, relu, kw = _operands("projection_join", torch.bfloat16)
    with torch.no_grad():
        assert K.fits(y, layer, relu=relu, **kw) and \
            not K.takes(y, layer, relu=relu, **kw)


def _tiled_conv_bn(device, dtype, n_h, n_w, relu=True):
    """(whole, tiled, the tiles' count) of one ``conv_bn`` on a whole
    map and over an n_h x n_w spatial mesh's tiles."""
    from squeezedet_torch.parallel.mesh import make_mesh_spatial
    layer = _layer(16, 0, device=device)
    layer.weight = torch.nn.Parameter(
        torch.randn(16, 8, 3, 3, generator=torch.Generator()
                    .manual_seed(1)).to(device) * 0.1, requires_grad=False)
    x = torch.randn(2, 24, 20, 8, generator=torch.Generator()
                    .manual_seed(2)).to(device, dtype)
    with torch.no_grad():
        whole = L.conv_bn(layer, x, 1, relu=relu, eps=EPS)
        tiled = make_mesh_spatial(n_h, n_w, device=device).tiling() \
            .split(x, 2, 2)
        got = L.conv_bn(layer, tiled, 1, relu=relu, eps=EPS).gather()
    return whole, got, n_h * n_w


def test_tiles_reach_the_wrapper_and_int8_layers_never_do(monkeypatch):
    """Each tile of a spatial mesh is a whole ``conv_bn``: it calls
    ``bn_act`` as a whole map does, and the gathered tiles equal the whole
    map; an int8 layer takes its own path and never calls it."""
    calls = []

    def recording(*a, **k):
        calls.append(a[0].shape)
        return K.bn_act(*a, **k)
    monkeypatch.setattr(L, "bn_act", recording)
    whole, got, tiles = _tiled_conv_bn("cpu", torch.float32, 2, 1)
    assert len(calls) == 1 + tiles and torch.equal(got, whole)
    qconv = L.QConv(torch.ones(16, 8, 1, 1, dtype=torch.int8),
                    torch.ones(16), torch.zeros(16), in_scale=0.1)
    L.conv_bn(qconv, torch.randn(1, 12, 10, 8), 1, eps=EPS)
    assert len(calls) == 1 + tiles


def _forward_before(net, x):
    """ResNet50's forward with each conv + batch norm and join as before
    K4 (``_before``), from the same layers."""
    def conv_bn(layer, x, stride, relu=True):
        y = L._conv_nchw(x, layer.weight, None, stride, "SAME")
        return _before(y, layer, net.eps, relu).permute(0, 2, 3, 1)
    from squeezedet_torch.models.resnet50 import _STAGES
    x = L.max_pool(conv_bn(net.conv1, x, 2), 3, 2, "VALID")
    for stage, blocks, _, _, _ in _STAGES:
        for block in blocks:
            res = getattr(net, "res" + stage + block)
            stride = 1 if block != "a" or stage == "2" else 2
            shortcut = x if block != "a" else \
                conv_bn(res.branch1, x, stride, relu=False)
            y = conv_bn(res.branch2.branch2a, x, stride)
            y = conv_bn(res.branch2.branch2b, y, 1)
            y = conv_bn(res.branch2.branch2c, y, 1, relu=False)
            x = F.relu(shortcut + y)
    return L.conv2d(net.conv5, x, 1, relu=False)


def _resnet50(dtype=torch.float32, device="cpu", state=None):
    """The tiny ResNet50 in ``dtype``, its batch norms drawn away from the
    identity (or loaded from ``state``)."""
    cfg = st.tiny_test_config("resnet50").replace(
        compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    det = st.get_model("resnet50", cfg, device=device)
    if state is not None:
        det.backbone.load_state_dict(state)
        return det
    for i, m in enumerate(det.backbone.modules()):
        if isinstance(m, L.ConvBN):
            drawn = _layer(m.gamma.shape[0], i, device=device)
            for name in ("gamma", "beta", "mean", "var"):
                getattr(m, name).data.copy_(getattr(drawn, name))
    return det


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_resnet50_forward_is_the_one_before_k4(dtype):
    net = _resnet50().backbone
    x = (torch.randn(2, 96, 96, 3, generator=torch.Generator()
                     .manual_seed(4)) * 60).to(dtype)
    with torch.no_grad():
        got = net(x)
        want = _forward_before(net, x)
    assert torch.equal(_bits(got), _bits(want))


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")


def _kitti_shapes():
    """(B, C, H, W, form) of each conv + batch norm and join of
    ``resnet50_kitti`` at 1242x375, B=2, once each."""
    shapes = [(2, 64, 188, 621, "bias_relu")]
    for c, h, w in ((64, 93, 310), (128, 47, 155), (256, 24, 78)):
        shapes += [(2, c, h, w, "relu"), (2, 4 * c, h, w, "projection_join"),
                   (2, 4 * c, h, w, "identity_join")]
    return shapes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_k4_equals_plain_at_resnet50_kitti_shapes(dtype):
    _card()
    for b, c, h, w, form in _kitti_shapes():
        y, layer, relu, kw = _operands(form, dtype, (b, c, h, w), "cuda")
        with torch.no_grad():  # scoring
            want = K.bn_act_reference(y, layer, EPS, relu=relu, **kw)
            before = K.LAUNCHES
            got = K.bn_act(y.clone(memory_format=torch.channels_last),
                           layer, EPS, relu=relu, **kw)
        assert K.LAUNCHES == before + 1, (form, c)
        assert torch.equal(_bits(got), _bits(want)), (form, c, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n_h,n_w", [(2, 1), (2, 2)])
def test_cuda_tiles_launch_k4_bit_for_bit_the_plain_version(n_h, n_w, dtype,
                                                            monkeypatch):
    """On the card a spatial mesh's tiles launch K4, once a tile, bit for
    bit the same tiles with K4 routed off; a layer without ReLU keeps the
    plain version.  (cuDNN may round a tile's bf16 conv apart from the
    whole map's, so the whole map is no bit-for-bit yardstick here;
    ``chip_smoke.py`` holds tiled forwards to the unsharded one.)"""
    _card()
    before = K.LAUNCHES
    _, got, tiles = _tiled_conv_bn("cuda", dtype, n_h, n_w)
    assert K.LAUNCHES == before + 1 + tiles
    _tiled_conv_bn("cuda", dtype, n_h, n_w, relu=False)
    assert K.LAUNCHES == before + 1 + tiles
    monkeypatch.setattr(K, "takes", lambda *a, **k: False)
    _, want, _ = _tiled_conv_bn("cuda", dtype, n_h, n_w)
    assert K.LAUNCHES == before + 1 + tiles
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_cuda_k4_refuses_a_traced_call(monkeypatch):
    """Under ``torch.export`` or ``torch.compile`` (fake tensors) the call
    keeps the torch ops."""
    _card()
    y, layer, _, kw = _operands("projection_join", torch.bfloat16,
                                device="cuda")
    with torch.no_grad():
        assert K.takes(y, layer, relu=True, **kw)
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert not K.takes(y, layer, relu=True, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_scoring_forward_launches_k4_40_times(dtype, monkeypatch):
    """ResNet50's scoring forward: 40 launches (conv1, each block's 2a
    and 2b, each join), the same preds as with K4 routed off; squeezeDet
    launches none."""
    _card()
    det = _resnet50(dtype, "cuda")
    u8 = torch.randint(0, 256, (2, 96, 96, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0)).cuda()
    before = K.LAUNCHES
    got = det.predict_raw(u8)
    assert K.LAUNCHES == before + 40
    monkeypatch.setattr(K, "takes", lambda *a, **k: False)
    want = det.predict_raw(u8)
    assert K.LAUNCHES == before + 40
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    monkeypatch.undo()
    sq = st.get_model("squeezeDet", st.tiny_test_config(), device="cuda")
    sq.predict_raw(u8)
    assert K.LAUNCHES == before + 40


def _dispatch_inputs(k, b=2, g=4, rows=5, seed=0):
    """(dataset, stacked inputs) of a device-dataset dispatch of k steps
    of batch b on the card (as tests/test_torch_tracing.py's)."""
    rng = np.random.RandomState(seed)
    dataset = rng.randint(0, 256, (rows, 110, 120, 3)).astype(np.uint8)
    pos = rng.randint(0, rows, (k, b)).astype(np.int32)
    dx, dy = rng.randint(-6, 7, (k, b)), rng.randint(-6, 7, (k, b))
    aug = np.stack([dx, dy, rng.randint(0, 2, (k, b)), 120 - dx, 110 - dy],
                   axis=-1).astype(np.float32)
    boxes = np.stack([rng.uniform(15, 80, (k, b, g)),
                      rng.uniform(15, 80, (k, b, g)),
                      rng.uniform(10, 40, (k, b, g)),
                      rng.uniform(10, 40, (k, b, g))],
                     axis=-1).astype(np.float32)
    labels = rng.randint(0, 3, (k, b, g)).astype(np.int32)
    num_gt = rng.randint(1, g + 1, (k, b)).astype(np.int32)
    return (torch.from_numpy(dataset).cuda(),
            [torch.from_numpy(a).cuda()
             for a in (pos, aug, boxes, labels, num_gt)])


@pytest.mark.cuda
def test_cuda_captured_dispatch_counts_22_a_step():
    """A captured K=2 ResNet50 dispatch holds 22 launches a step (conv1,
    res2 and res3: the frozen layers; res4 trains and keeps its torch
    ops); ``CapturedLaunches`` adds them at each replay."""
    _card()
    from squeezedet_torch.optim import build_optimizer
    from squeezedet_torch.trainer import (TrainState,
                                          make_train_step_device_scan)
    k = 2
    det = _resnet50(torch.bfloat16, "cuda")
    scan = make_train_step_device_scan(
        TrainState(det, build_optimizer(det.cfg, det)), k, uint8_ingest=True,
        device_augment=True, device_dataset=True)
    dataset, stacked = _dispatch_inputs(k)
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = K.LAUNCHES
    scan(dataset, *stacked, generator=gen)  # eager
    assert K.LAUNCHES == before + 22 * k
    scan(dataset, *stacked, generator=gen)  # captured, then replayed
    scan(dataset, *stacked, generator=gen)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 3 * 22 * k
    assert scan.launches.per_replay[_cuda._counters().index(
        (K, "LAUNCHES"))] == 22 * k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_train_step_equals_k4_routed_off(dtype, monkeypatch):
    """One ResNet50 device train step from the same weights, batch and
    generator, in deterministic mode, with K4 (22 launches) and with it
    routed off (0): the loss terms, every parameter and every momentum
    leaf bit for bit."""
    _card()
    from squeezedet_torch.optim import build_optimizer
    from squeezedet_torch.trainer import (TrainState, deterministic,
                                          make_train_step_device)
    weights = _resnet50(dtype).backbone.state_dict()
    u8 = torch.randint(0, 256, (2, 96, 96, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1)).cuda()
    boxes = torch.tensor([[[40.0, 40.0, 20.0, 30.0], [60.0, 50.0, 30.0,
                                                       20.0]]] * 2).cuda()
    labels = torch.tensor([[0, 2]] * 2).cuda()

    def step():
        det = _resnet50(dtype, "cuda", weights)
        state = TrainState(det, build_optimizer(det.cfg, det))
        launches = K.LAUNCHES
        with deterministic():
            lb = make_train_step_device(state, uint8_ingest=True)(
                u8, boxes, labels, torch.tensor([2, 1]).cuda(),
                generator=torch.Generator("cuda").manual_seed(2))
        return (lb, det.backbone.state_dict(), state.opt.trace,
                K.LAUNCHES - launches)

    k4 = step()
    monkeypatch.setattr(K, "takes", lambda *a, **k: False)
    plain = step()
    assert (k4[3], plain[3]) == (22, 0)
    assert all(torch.equal(a, b) for a, b in zip(k4[0], plain[0]))
    for got, want in zip(k4[1:3], plain[1:3]):
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), name
