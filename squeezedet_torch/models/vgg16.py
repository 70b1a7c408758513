"""VGG16 + ConvDet backbone (counterpart of
``squeezedet_tpu/models/vgg16.py``).

conv1_1..conv5_3, 3x3 s1 SAME with ReLU (the conv1 and conv2 blocks
frozen), a 2x2 stride-2 SAME max-pool after each of blocks 1-4, dropout
(training), then the ConvDet head ``conv6`` (APG*(C+1+4) channels, 3x3,
no relu, stddev 1e-4).  Overall stride 16.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from squeezedet_torch.models import layers as L

# (name, filters, frozen) per conv; pools follow blocks 1-4.
_CONVS = [
    ("conv1_1", 64, True), ("conv1_2", 64, True),
    ("conv2_1", 128, True), ("conv2_2", 128, True),
    ("conv3_1", 256, False), ("conv3_2", 256, False), ("conv3_3", 256, False),
    ("conv4_1", 512, False), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv5_1", 512, False), ("conv5_2", 512, False), ("conv5_3", 512, False),
]
_POOL_AFTER = {"conv1_2": "pool1", "conv2_2": "pool2",
               "conv3_3": "pool3", "conv4_3": "pool4"}


class VGG16(nn.Module):
    """Backbone + head parameters; ``forward`` maps [B, H, W, 3] BGR
    mean-subtracted images to ConvDet preds [B, Hg, Wg, APG*(C+5)], both
    NHWC, in the images' dtype."""

    def __init__(self, cfg, *, device, generator: torch.Generator):
        super().__init__()
        self.keep_prob = cfg.keep_prob
        self.tracer = L.NetTracer.for_config(cfg)
        xavier = cfg.scratch_init == "xavier"
        for name, filters, frozen in _CONVS:
            self.add_module(name, L.init_conv(
                generator, self.tracer, name, filters, 3, 1, device=device,
                freeze=frozen, xavier=xavier))
            if name in _POOL_AFTER:
                self.tracer.pool(_POOL_AFTER[name], 2, 2, "SAME")
        self.conv6 = L.init_conv(generator, self.tracer, "conv6",
                                 cfg.head_channels, 3, 1, device=device,
                                 xavier=False, relu=False, stddev=0.0001)

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                tape=None) -> torch.Tensor:
        """In training, one dropout draw from ``generator`` masks conv5_3's
        output before the head.  ``tape`` (a dict, or None) receives each
        conv's activation under its layer name."""
        x = images
        for name, _, _ in _CONVS:
            x = L.conv2d(getattr(self, name), x, 1)
            L.record(tape, name, x)
            if name in _POOL_AFTER:
                x = L.max_pool(x, 2, 2, "SAME")
        x = L.dropout(x, self.keep_prob, generator, train)
        out = L.conv2d(self.conv6, x, 1, relu=False)
        L.record(tape, "conv6", out)
        return out
