"""A toy reference network for the tests: what a configuration's own
reference module gives (:mod:`portbench.reference`), for a net that a
layer list cannot write.

A stem conv (5x5, stride 4, SAME) with its batch norm and ReLU, frozen;
a 3x3 stride-2 SAME max-pool; dropout; one bottleneck block: the
projection shortcut ``res.branch1`` (1x1, stride 2, batch norm) beside
``res.branch2``'s 1x1 stride-2 -> 3x3 -> 1x1 convs, each with its batch
norm (ReLU after the first two), joined as relu(shortcut + branch);
dropout over the join's two halves, one after the other; the head conv
(3x3, bias, no ReLU).  Batch norm keeps frozen statistics: gamma * (y -
mean) / sqrt(var + eps) + beta, ``mean`` and ``var`` buffers of the
program.  Overall stride 16, as squeezeDet's.  Plain PyTorch, float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

STEM, MID, OUT = 16, 8, 32
# (name, in channels, filters, size, stride, relu); the stem's input is
# the image, the branches' the pooled stem
CONV_BN = [("stem", 3, STEM, 5, 4, True),
           ("res.branch1", STEM, OUT, 1, 2, False),
           ("res.branch2.branch2a", STEM, MID, 1, 2, True),
           ("res.branch2.branch2b", MID, MID, 3, 1, True),
           ("res.branch2.branch2c", MID, OUT, 1, 1, False)]
HEAD = "head"


def _same(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, total // 2, total - total // 2


def _sizes(cfg):
    """(height, width) after the stem, after the pool, after the block."""
    h, w = cfg["image_height"], cfg["image_width"]
    out = []
    for k, s in ((5, 4), (3, 2), (1, 2)):
        h, w = _same(h, k, s)[0], _same(w, k, s)[0]
        out.append((h, w))
    return out


def _head_filters(cfg):
    return cfg["anchor_per_grid"] * (cfg["classes"] + 5)


def conv_shapes(cfg):
    (sh, sw), _, (gh, gw) = _sizes(cfg)
    out = [(name, c, o, k, s, gh, gw, relu)
           for name, c, o, k, s, relu in CONV_BN]
    out[0] = out[0][:5] + (sh, sw) + out[0][7:]
    return out + [(HEAD, OUT, _head_filters(cfg), 3, 1, gh, gw, False)]


def param_shapes(cfg):
    shapes = {}
    for name, c, o, k, _, _ in CONV_BN:
        shapes[name + ".weight"] = (o, c, k, k)
        shapes[name + ".gamma"] = shapes[name + ".beta"] = (o,)
    shapes[HEAD + ".weight"] = (_head_filters(cfg), OUT, 3, 3)
    shapes[HEAD + ".bias"] = (_head_filters(cfg),)
    return shapes


def buffer_shapes(cfg):
    shapes = {}
    for name, _, o, _, _, _ in CONV_BN:
        shapes[name + ".mean"] = shapes[name + ".var"] = (o,)
    return shapes


def frozen_params(cfg):
    return {"stem.weight", "stem.gamma", "stem.beta"}


def head(cfg):
    return HEAD


def grid(cfg):
    return _sizes(cfg)[2]


def dropout_parts(cfg):
    (_, _), (ph, pw), (gh, gw) = _sizes(cfg)
    return [(ph, pw, (STEM,)), (gh, gw, (OUT // 2, OUT // 2))]


def k2_routed(cfg):
    """None: the program takes a batch-normed conv's weight gradient
    from cuDNN, and the head is 3x3."""
    return []


def draw(seed, cfg, device):
    """Kernels and the head's bias by ``he_weights`` (one draw, under its
    own tag); gamma, beta, mean and var from one normal draw under the
    tag ``"batch_norm"``: 1 + 0.1 z, 0.1 z, 0.1 z and exp(0.2 z)."""
    from portbench import traffic
    shapes = param_shapes(cfg)
    kernels = {n: s for n, s in shapes.items()
               if n.endswith((".weight", ".bias"))}
    out = traffic.he_weights(seed, kernels, cfg["init"], device)
    norm = {n: s for n, s in {**shapes, **buffer_shapes(cfg)}.items()
            if n not in kernels}
    for name, z in traffic.normal_parts(seed, "batch_norm", norm,
                                        device).items():
        kind = name.rsplit(".", 1)[1]
        out[name] = {"gamma": 1.0 + 0.1 * z, "beta": 0.1 * z,
                     "mean": 0.1 * z, "var": torch.exp(0.2 * z)}[kind]
    return out


def _conv(x, weight, bias, stride, quant):
    k = weight.shape[2]
    _, pt, pb = _same(x.shape[2], k, stride)
    _, pl, pr = _same(x.shape[3], k, stride)
    x = F.pad(x, (pl, pr, pt, pb))
    if quant is not None:
        x, weight = quant(x), quant(weight)
    return F.conv2d(x, weight, bias, stride=stride)


def _conv_bn(t, name, x, stride, relu, eps, quant):
    y = _conv(x, t[name + ".weight"], None, stride, quant)

    def per_channel(v):
        return t[name + "." + v][None, :, None, None]
    y = (y - per_channel("mean")) / torch.sqrt(per_channel("var") + eps) \
        * per_channel("gamma") + per_channel("beta")
    return F.relu(y) if relu else y


def forward(cfg, tensors, images, masks=None, quant=None):
    eps, keep_prob = cfg["batch_norm_epsilon"], cfg["keep_prob"]
    drops = iter(masks or ())

    def dropout(x):
        if masks is None:
            return x
        keep = next(drops).permute(0, 3, 1, 2)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    layers = {name: (s, relu) for name, _, _, _, s, relu in CONV_BN}

    def conv_bn(name, x):
        return _conv_bn(tensors, name, x, *layers[name], eps, quant)
    x = conv_bn("stem", images.permute(0, 3, 1, 2).float())
    _, pt, pb = _same(x.shape[2], 3, 2)
    _, pl, pr = _same(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=-math.inf), 3, 2)
    x = dropout(x)
    y = x
    for part in ("branch2a", "branch2b", "branch2c"):
        y = conv_bn("res.branch2." + part, y)
    x = dropout(F.relu(conv_bn("res.branch1", x) + y))
    x = _conv(x, tensors[HEAD + ".weight"], tensors[HEAD + ".bias"], 1,
              quant)
    return x.permute(0, 2, 3, 1)
