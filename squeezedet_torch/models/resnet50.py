"""ResNet50 (conv1..conv4_x) + ConvDet backbone (counterpart of
``squeezedet_tpu/models/resnet50.py``).

conv1 (7x7 s2 SAME conv with bias + batch norm, frozen) -> pool1 (3x3 s2
VALID) -> res2a-c (frozen) -> res3a-d (frozen) -> res4a-f (trained) ->
dropout (training) -> ConvDet head ``conv5`` (APG*(C+1+4) channels, 3x3,
no relu, stddev 1e-4).  Each block's branch2 is a 1x1 -> 3x3 -> 1x1
bottleneck of conv + frozen-statistics batch norm; block a adds a
projection shortcut ``branch1`` (stride 2 in res3a and res4a), the
others the identity; the join is relu(shortcut + branch2c).  Batch norm
never updates its statistics (``layers.conv_bn``).

Layer names follow the caffe model the reference loads: ``conv1`` with
``bn_conv1``/``scale_conv1``, ``res2a_branch2a`` with
``bn2a_branch2a``/``scale2a_branch2a`` (:func:`caffe_names`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from squeezedet_torch.models import layers as L
from squeezedet_torch.utils.profiling import span

# (stage, blocks, in_filters, out_filters, frozen)
_STAGES = [
    ("2", ["a", "b", "c"], 64, 256, True),
    ("3", ["a", "b", "c", "d"], 128, 512, True),
    ("4", ["a", "b", "c", "d", "e", "f"], 256, 1024, False),
]
_BRANCH2 = ("branch2a", "branch2b", "branch2c")


def caffe_names(prefix: str) -> Tuple[str, str, str]:
    """(conv, batch-norm, scale) entry names in the caffe pickle of the
    conv + batch norm layer at state_dict prefix ``prefix``: 'conv1' ->
    ('conv1', 'bn_conv1', 'scale_conv1'); 'res2a.branch1' ->
    ('res2a_branch1', 'bn2a_branch1', 'scale2a_branch1');
    'res2a.branch2.branch2a' -> ('res2a_branch2a', ...)."""
    parts = prefix.split(".")
    if len(parts) == 1:
        return prefix, "bn_" + prefix, "scale_" + prefix
    conv = parts[0] + "_" + parts[-1]
    tag = conv[len("res"):]
    return conv, "bn" + tag, "scale" + tag


class ResNet50(nn.Module):
    """Backbone + head parameters (and batch-norm statistics);
    ``forward`` maps [B, H, W, 3] BGR mean-subtracted images to ConvDet
    preds [B, Hg, Wg, APG*(C+5)], both NHWC, in the images' dtype."""

    def __init__(self, cfg, *, device, generator: torch.Generator):
        super().__init__()
        self.keep_prob = cfg.keep_prob
        self.eps = cfg.batch_norm_epsilon
        self.tracer = L.NetTracer.for_config(cfg)
        xavier = cfg.scratch_init == "xavier"

        def conv_bn(prefix, filters, size, stride, **kw):
            conv, bn, scale = caffe_names(prefix)
            return L.init_conv_bn(generator, self.tracer, conv, filters, size,
                                  stride, device=device, bn_name=bn,
                                  scale_name=scale, xavier=xavier, **kw)

        self.conv1 = conv_bn("conv1", 64, 7, 2, freeze=True,
                             conv_with_bias=True)
        self.tracer.pool("pool1", 3, 2, "VALID")
        for stage, blocks, in_f, out_f, frozen in _STAGES:
            for block in blocks:
                name = "res" + stage + block
                res = nn.Module()
                stride = 1
                if block == "a":
                    stride = 1 if stage == "2" else 2
                    snap = self.tracer.snapshot()
                    res.branch1 = conv_bn(name + ".branch1", out_f, 1, stride,
                                          freeze=frozen, relu=False)
                    self.tracer.restore(snap)
                res.branch2 = nn.Module()
                for sub, (f, size, st, relu) in zip(_BRANCH2, (
                        (in_f, 1, stride, True), (in_f, 3, 1, True),
                        (out_f, 1, 1, False))):
                    res.branch2.add_module(sub, conv_bn(
                        "{}.branch2.{}".format(name, sub), f, size, st,
                        freeze=frozen, relu=relu))
                self.add_module(name, res)
        self.conv5 = L.init_conv(generator, self.tracer, "conv5",
                                 cfg.head_channels, 3, 1, device=device,
                                 xavier=False, relu=False, stddev=0.0001)

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                tape=None) -> torch.Tensor:
        """In training, one dropout draw from ``generator`` masks res4f's
        output before the head.  ``tape`` (a dict, or None) receives conv1,
        each block's branch2a and branch2b and each block's output under
        the JAX backbone's names (``res2a_branch2a``, ``res2a``).

        Each stage's blocks are the device span ``res<stage>``
        (``utils/profiling.span``) on the images' device; over a spatial
        mesh's tiles, a host range only.

        An int8 block (``quant._quantize_resnet``) carries buffers: its
        identity shortcut, when int8, is dequantized at ``shortcut_scale``
        (branch2c and a projection shortcut already come out f32), the join
        runs in f32, and the block output is re-quantized at
        ``out_scale``."""
        eps = self.eps
        x = L.conv_bn(self.conv1, images, 2, eps=eps)
        L.record(tape, "conv1", x)
        x = L.max_pool(x, 3, 2, "VALID")
        dev = images.device if torch.is_tensor(images) else None
        for stage, blocks, _, _, _ in _STAGES:
            with span("res" + stage, dev):
                for block in blocks:
                    x = self._block(stage, block, x, tape)
        x = L.dropout(x, self.keep_prob, generator, train)
        out = L.conv2d(self.conv5, x, 1, relu=False)
        L.record(tape, "conv5", out)
        return out

    def _block(self, stage: str, block: str, x, tape):
        """Block ``res<stage><block>`` on ``x``.  branch2c's batch norm, and
        a projection shortcut's, are left pending (``layers.PendingBN``)
        for the join, which applies them with its add and ReLU in one pass
        (``layers.join``)."""
        eps = self.eps
        name = "res" + stage + block
        res = getattr(self, name)
        stride = 1
        shortcut = x
        if block == "a":
            stride = 1 if stage == "2" else 2
            shortcut = L.conv_bn(res.branch1, x, stride, relu=False,
                                 eps=eps, pending=True)
        elif getattr(res, "shortcut_scale", None) is not None:
            shortcut = L.pointwise(
                lambda s, scale=res.shortcut_scale:
                s.float() * scale.to(s.device), shortcut)
        b2 = res.branch2
        y = L.conv_bn(b2.branch2a, x, stride, eps=eps)
        L.record(tape, name + "_branch2a", y)
        y = L.conv_bn(b2.branch2b, y, 1, eps=eps)
        L.record(tape, name + "_branch2b", y)
        y = L.conv_bn(b2.branch2c, y, 1, relu=False, eps=eps, pending=True)
        x = L.pointwise(lambda s, t: L.join(s, t, eps), shortcut, y)
        if getattr(res, "out_scale", None) is not None:
            x = L.pointwise(lambda t, scale=res.out_scale:
                            L.quantize_activation(t, scale), x)
        L.record(tape, name, x)
        return x
