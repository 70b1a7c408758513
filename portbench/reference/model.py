"""The backbones and the ConvDet head from the configuration's layer
list (BichenWuUCB/squeezeDet ``src/nets/squeezeDet.py`` and
``squeezeDetPlus.py``; arXiv:1612.01051), in float32 NCHW.

A layer list holds ``conv``, ``pool``, ``fire`` and ``dropout`` entries
in order.  Padding is TensorFlow's: SAME pads ``total // 2`` before and
the rest after, a max-pool's pad is -inf.  A fire module is
squeeze1x1 -> ReLU -> (expand1x1 -> ReLU) ++ (expand3x3 SAME -> ReLU),
concatenated on channels.  Parameters are named ``<layer>.weight``
(OIHW) and ``<layer>.bias``, a fire's convs ``<fire>.squeeze1x1`` and so
on.

``quant``, when given, is applied to every conv's input and weight
before the conv (the control's lower precision, :mod:`.precision`).

This is the network of a configuration that names no ``"reference"``;
it gives what :mod:`portbench.reference` lists.  It keeps no buffers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _pads(size, k, s, padding):
    if padding == "VALID":
        return -(-(size - k + 1) // s), 0, 0
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, total // 2, total - total // 2


def conv_shapes(cfg):
    """Every conv of the configuration in order: (name, in channels,
    filters, size, stride, out height, out width, relu)."""
    h, w, c = cfg["image_height"], cfg["image_width"], 3
    out = []
    for layer in cfg["layers"]:
        if "conv" in layer:
            k, s, pad = layer["size"], layer["stride"], layer["padding"]
            h, w = _pads(h, k, s, pad)[0], _pads(w, k, s, pad)[0]
            out.append((layer["conv"], c, layer["filters"], k, s, h, w,
                        layer.get("relu", True)))
            c = layer["filters"]
        elif "pool" in layer:
            k, s, pad = layer["size"], layer["stride"], layer["padding"]
            h, w = _pads(h, k, s, pad)[0], _pads(w, k, s, pad)[0]
        elif "fire" in layer:
            name = layer["fire"]
            sq, e1, e3 = layer["s1x1"], layer["e1x1"], layer["e3x3"]
            out.append((name + ".squeeze1x1", c, sq, 1, 1, h, w, True))
            out.append((name + ".expand1x1", sq, e1, 1, 1, h, w, True))
            out.append((name + ".expand3x3", sq, e3, 3, 1, h, w, True))
            c = e1 + e3
    return out


def grid(cfg):
    """(grid height, grid width) of the head's output."""
    last = conv_shapes(cfg)[-1]
    return last[5], last[6]


def param_shapes(cfg):
    """{name: shape} of every parameter, in layer order."""
    shapes = {}
    for name, c, o, k, _, _, _, _ in conv_shapes(cfg):
        shapes[name + ".weight"] = (o, c, k, k)
        shapes[name + ".bias"] = (o,)
    return shapes


def buffer_shapes(cfg):
    """{name: shape} of the program's buffers: a layer list has none."""
    return {}


def head(cfg):
    """The head conv's name: the last conv."""
    return conv_shapes(cfg)[-1][0]


def dropout_parts(cfg):
    """For each ``dropout`` entry in order: (height, width, channel parts
    of its input).  The entry before it decides: a fire gives its two
    expand halves, which the program masks one after the other; a conv
    gives its filters as one part."""
    shapes = conv_shapes(cfg)
    out, seen, parts = [], 0, None
    for layer in cfg["layers"]:
        if "conv" in layer:
            seen, parts = seen + 1, (layer["filters"],)
        elif "fire" in layer:
            seen, parts = seen + 3, (layer["e1x1"], layer["e3x3"])
        elif "dropout" in layer:
            if parts is None:
                raise ValueError("{}: {} follows no conv or fire".format(
                    cfg.get("name"), layer["dropout"]))
            out.append(shapes[seen - 1][5:7] + (parts,))
        else:
            parts = None
    return out


def k2_routed(cfg):
    """(kernel size, in channels, filters, height, width) of each conv
    whose weight gradient the "1x1" route gives K2
    (:func:`portbench.frozen.k2_1x1_routed`).  A fire's squeeze takes the
    two halves of the previous fire's output as two parts."""
    from portbench import frozen
    parts, out = {}, []
    prev = None
    for layer in cfg["layers"]:
        if "fire" in layer:
            parts[layer["fire"]] = prev
            prev = (layer["e1x1"], layer["e3x3"])
        elif "conv" in layer:
            prev = (layer["filters"],)
    for name, c, o, k, s, h, w, _ in conv_shapes(cfg):
        fire, _, part = name.partition(".")
        ins = parts.get(fire) if part == "squeeze1x1" else (c,)
        if ins and frozen.k2_1x1_routed(k, s, ins, h, w, o):
            out.append((k, c, o, h, w))
    return out


def draw(seed, cfg, device):
    """The parameters from the seed: :func:`portbench.traffic.he_weights`
    over :func:`param_shapes`, in one draw."""
    from portbench import traffic
    return traffic.he_weights(seed, param_shapes(cfg), cfg["init"], device)


def frozen_params(cfg):
    """Names of the parameters that do not train (a ``frozen`` conv)."""
    names = set()
    for layer in cfg["layers"]:
        if "conv" in layer and layer.get("frozen"):
            names |= {layer["conv"] + ".weight", layer["conv"] + ".bias"}
    return names


def _conv(x, weight, bias, stride, padding, quant):
    k = weight.shape[2]
    _, pt, pb = _pads(x.shape[2], k, stride, padding)
    _, pl, pr = _pads(x.shape[3], k, stride, padding)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))
    if quant is not None:
        x, weight = quant(x), quant(weight)
    return F.conv2d(x, weight, bias, stride=stride)


def _pool(x, size, stride, padding):
    _, pt, pb = _pads(x.shape[2], size, stride, padding)
    _, pl, pr = _pads(x.shape[3], size, stride, padding)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
    return F.max_pool2d(x, size, stride)


def forward(cfg, params, images, masks=None, quant=None):
    """Mean-subtracted BGR images [B, H, W, 3] -> the head's raw output
    [B, Hg, Wg, APG * (C + 5)] (NHWC), float32.  ``masks``: for each
    ``dropout`` layer in training, the keep mask of its input, NHWC
    bool; None (inference) leaves dropout out.  ``params``: {name:
    tensor}."""
    x = images.permute(0, 3, 1, 2).float()
    drops = iter(masks or ())
    keep_prob = cfg["keep_prob"]
    for layer in cfg["layers"]:
        if "conv" in layer:
            n = layer["conv"]
            x = _conv(x, params[n + ".weight"], params[n + ".bias"],
                      layer["stride"], layer["padding"], quant)
            if layer.get("relu", True):
                x = F.relu(x)
        elif "pool" in layer:
            x = _pool(x, layer["size"], layer["stride"], layer["padding"])
        elif "fire" in layer:
            n = layer["fire"]

            def conv(part, inp, stride=1):
                return F.relu(_conv(inp, params[n + part + ".weight"],
                                    params[n + part + ".bias"], stride,
                                    "SAME", quant))
            sq = conv(".squeeze1x1", x)
            x = torch.cat([conv(".expand1x1", sq), conv(".expand3x3", sq)],
                          dim=1)
        elif "dropout" in layer and masks is not None:
            keep = next(drops).permute(0, 3, 1, 2)
            x = torch.where(keep, x / keep_prob, torch.zeros_like(x))
    return x.permute(0, 2, 3, 1)
