"""ResNet50-ConvDet (BichenWuUCB/squeezeDet ``src/nets/resnet50_convDet.py``
with ``src/nn_skeleton.py`` ``_conv_bn_layer``; the residual network of
arXiv:1512.03385, the ConvDet head of arXiv:1612.01051), in float32 NCHW.

``conv1`` (7x7 stride 2 SAME, with bias) -> ``pool1`` (3x3 stride 2
VALID) -> the stages of the configuration's ``stages`` (``res2`` a-c,
``res3`` a-d, ``res4`` a-f) -> dropout -> the head ``conv5`` (3x3 SAME,
bias, no ReLU).  A block's ``branch2`` is a 1x1 (the stage's stride in
block a) -> 3x3 -> 1x1 bottleneck; block a's shortcut is the projection
``branch1`` (1x1, the stage's stride), the others' the block's input; the
join is relu(shortcut + branch2c).  Every conv but the head's is followed
by its batch norm with frozen statistics, tf.nn.batch_normalization's
gamma * (y - mean) / sqrt(var + eps) + beta, and a ReLU except on
``branch1`` and ``branch2c``.  Padding is TensorFlow's: SAME pads
``total // 2`` before and the rest after.

Names are the program's backbone's (``res2a.branch2.branch2a.weight``;
``.gamma``, ``.beta``; the statistics ``.mean`` and ``.var``, which the
program keeps as buffers).  ``quant``, when given, is applied to every
conv's input and weight before the conv (:mod:`.precision`).

Departures from the published code: the published network loads
ImageNet weights (``resnet50_weights.pkl``) and this one draws them from
the seed (:func:`draw`; the statistics and affines are not the
identity); the stages' widths are read from the configuration, which
states the published ones; dropout takes the keep mask it is given, as
the benchmark hands the program its generator's draw.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import _conv, _pads, _pool

HEAD = "conv5"
BRANCH2 = ("branch2a", "branch2b", "branch2c")
# the draw's tag of the batch norms' statistics and affines
BN_TAG = "resnet50_batch_norm"


def _blocks(cfg):
    """Every block in order: (name, stage, index in its stage)."""
    return [(s["stage"] + chr(ord("a") + i), s, i)
            for s in cfg["stages"] for i in range(s["blocks"])]


def _conv_bns(cfg):
    """Every conv with a batch norm, in the program's order: (name, in
    channels, filters, size, stride, relu, frozen); a block's input is
    the previous block's output."""
    c1 = cfg["conv1"]
    out = [("conv1", 3, c1["filters"], c1["size"], c1["stride"], True,
            c1["frozen"])]
    c = c1["filters"]
    for name, s, i in _blocks(cfg):
        stride = s["stride"] if i == 0 else 1
        frozen = s["frozen"]
        if i == 0:
            out.append((name + ".branch1", c, s["out"], 1, stride, False,
                        frozen))
        for part, (ci, o, k, st, relu) in zip(BRANCH2, (
                (c, s["mid"], 1, stride, True),
                (s["mid"], s["mid"], 3, 1, True),
                (s["mid"], s["out"], 1, 1, False))):
            out.append(("{}.branch2.{}".format(name, part), ci, o, k, st,
                        relu, frozen))
        c = s["out"]
    return out


def _head_filters(cfg):
    return cfg["anchor_per_grid"] * (cfg["classes"] + 5)


def conv_shapes(cfg):
    """Every conv in order: (name, in channels, filters, size, stride,
    out height, out width, relu)."""
    h, w = cfg["image_height"], cfg["image_width"]
    out = []
    for name, c, o, k, s, relu, _ in _conv_bns(cfg):
        oh, ow = _pads(h, k, s, "SAME")[0], _pads(w, k, s, "SAME")[0]
        out.append((name, c, o, k, s, oh, ow, relu))
        if name.endswith(".branch1"):
            continue  # beside branch2a, on the same input
        h, w = oh, ow
        if name == "conv1":
            p = cfg["pool1"]
            h, w = (_pads(n, p["size"], p["stride"], p["padding"])[0]
                    for n in (h, w))
    c = cfg["stages"][-1]["out"]
    return out + [(HEAD, c, _head_filters(cfg), 3, 1, h, w, False)]


def grid(cfg):
    """(grid height, grid width) of the head's output."""
    return conv_shapes(cfg)[-1][5:7]


def param_shapes(cfg):
    """{name: shape} of every parameter, in the program's order."""
    shapes = {}
    for name, c, o, k, _, _, _ in _conv_bns(cfg):
        shapes[name + ".weight"] = (o, c, k, k)
        if name == "conv1" and cfg["conv1"]["bias"]:
            shapes[name + ".bias"] = (o,)
        shapes[name + ".gamma"] = shapes[name + ".beta"] = (o,)
    c = cfg["stages"][-1]["out"]
    shapes[HEAD + ".weight"] = (_head_filters(cfg), c, 3, 3)
    shapes[HEAD + ".bias"] = (_head_filters(cfg),)
    return shapes


def buffer_shapes(cfg):
    """{name: shape} of the batch norms' frozen statistics."""
    shapes = {}
    for name, _, o, _, _, _, _ in _conv_bns(cfg):
        shapes[name + ".mean"] = shapes[name + ".var"] = (o,)
    return shapes


def frozen_params(cfg):
    """conv1's and the frozen stages' parameters."""
    shapes = param_shapes(cfg)
    return {name + "." + kind
            for name, _, _, _, _, _, frozen in _conv_bns(cfg) if frozen
            for kind in ("weight", "bias", "gamma", "beta")
            if name + "." + kind in shapes}


def head(cfg):
    return HEAD


def dropout_parts(cfg):
    """One dropout, over the last block's output: one part."""
    gh, gw = grid(cfg)
    return [(gh, gw, (cfg["stages"][-1]["out"],))]


def k2_routed(cfg):
    """None: the program takes a batch-normed conv's weight gradient from
    cuDNN (``layers.conv_bn`` never routes to K2), and the head is 3x3."""
    return []


def draw(seed, cfg, device):
    """Kernels and biases by ``he_weights`` (one draw, under its own tag);
    every batch norm's gamma, beta, mean and var from one normal draw
    under the tag :data:`BN_TAG`, each z standard normal: gamma exp(0.2
    z) (times ``cfg["init"]["branch2c_gamma"]`` on a ``branch2c``, so
    that the residual stream stays O(1) over a stage's identity blocks),
    beta 0.1 z, mean 0.1 z, var exp(0.4 z)."""
    from portbench import traffic
    shapes = param_shapes(cfg)
    kernels = {n: s for n, s in shapes.items()
               if n.endswith((".weight", ".bias"))}
    out = traffic.he_weights(seed, kernels, cfg["init"], device)
    norm = {n: s for n, s in {**shapes, **buffer_shapes(cfg)}.items()
            if n not in kernels}
    for name, z in traffic.normal_parts(seed, BN_TAG, norm, device).items():
        layer, kind = name.rsplit(".", 1)
        if kind == "gamma":
            v = torch.exp(0.2 * z)
            if layer.endswith(".branch2c"):
                v = v * cfg["init"]["branch2c_gamma"]
        elif kind == "var":
            v = torch.exp(0.4 * z)
        else:
            v = 0.1 * z
        out[name] = v
    return out


def _conv_bn(t, name, x, stride, relu, eps, quant):
    y = _conv(x, t[name + ".weight"], t.get(name + ".bias"), stride, "SAME",
              quant)

    def per_channel(v):
        return t[name + "." + v][None, :, None, None]
    y = per_channel("gamma") * (y - per_channel("mean")) \
        / torch.sqrt(per_channel("var") + eps) + per_channel("beta")
    return F.relu(y) if relu else y


def forward(cfg, tensors, images, masks=None, quant=None):
    """Mean-subtracted BGR images [B, H, W, 3] -> the head's raw output
    [B, Hg, Wg, APG * (C + 5)] (NHWC), float32.  ``masks``: the keep mask
    of the dropout's input in training (NHWC bool); None leaves dropout
    out.  ``tensors``: {name: tensor}, parameters and statistics.  Sets
    TF32 off for cuDNN's convs and for matrix products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["batch_norm_epsilon"]
    x = images.permute(0, 3, 1, 2).float()
    c1, p = cfg["conv1"], cfg["pool1"]
    x = _conv_bn(tensors, "conv1", x, c1["stride"], True, eps, quant)
    x = _pool(x, p["size"], p["stride"], p["padding"])
    for name, s, i in _blocks(cfg):
        stride = s["stride"] if i == 0 else 1
        y = x
        for part, st, relu in zip(BRANCH2, (stride, 1, 1),
                                  (True, True, False)):
            y = _conv_bn(tensors, "{}.branch2.{}".format(name, part), y, st,
                         relu, eps, quant)
        shortcut = x if i else _conv_bn(tensors, name + ".branch1", x,
                                        stride, False, eps, quant)
        x = F.relu(shortcut + y)
    if masks is not None:
        keep = masks[0].permute(0, 3, 1, 2)
        x = torch.where(keep, x / cfg["keep_prob"], torch.zeros_like(x))
    x = _conv(x, tensors[HEAD + ".weight"], tensors[HEAD + ".bias"], 1,
              "SAME", quant)
    return x.permute(0, 2, 3, 1)
