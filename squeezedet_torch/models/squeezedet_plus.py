"""SqueezeDet+ backbone + ConvDet head (counterpart of
``squeezedet_tpu/models/squeezedet_plus.py``).

The wider variant: conv1 (96f 7x7 s2 VALID, frozen) -> pool1 ->
fire2..4 -> pool4 -> fire5..8 -> pool8 -> fire9..11 -> dropout
(training) -> conv12 ConvDet head (APG*(C+1+4) channels, 3x3, no relu,
stddev 1e-4).  All pools are 3x3 stride-2 VALID.  conv1 and pool1 run as
stock ops: K1 fits only squeezeDet's 3x3 SAME front end.  The fire chain
is concat-free, as in squeezeDet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from squeezedet_torch.models import layers as L

# (name, s1x1, e1x1, e3x3) for fire2..fire11.
_FIRES = [
    ("fire2", 96, 64, 64), ("fire3", 96, 64, 64),
    ("fire4", 192, 128, 128), ("fire5", 192, 128, 128),
    ("fire6", 288, 192, 192), ("fire7", 288, 192, 192),
    ("fire8", 384, 256, 256), ("fire9", 384, 256, 256),
    ("fire10", 384, 256, 256), ("fire11", 384, 256, 256),
]
_POOL_AFTER = {"fire4": "pool4", "fire8": "pool8"}


class SqueezeDetPlus(nn.Module):
    """Backbone + head parameters; ``forward`` maps [B, H, W, 3] BGR
    mean-subtracted images to ConvDet preds [B, Hg, Wg, APG*(C+5)], both
    NHWC, in the images' dtype."""

    def __init__(self, cfg, *, device, generator: torch.Generator):
        super().__init__()
        self.keep_prob = cfg.keep_prob
        self.tracer = L.NetTracer.for_config(cfg)
        xavier = cfg.scratch_init == "xavier"
        self.conv1 = L.init_conv(generator, self.tracer, "conv1", 96, 7, 2,
                                 device=device, padding="VALID", freeze=True,
                                 xavier=xavier)
        self.tracer.pool("pool1", 3, 2, "VALID")
        for name, s, e1, e3 in _FIRES:
            self.add_module(name, L.Fire(generator, self.tracer, name, s, e1,
                                         e3, device=device, xavier=xavier))
            if name in _POOL_AFTER:
                self.tracer.pool(_POOL_AFTER[name], 3, 2, "VALID")
        self.conv12 = L.init_conv(generator, self.tracer, "conv12",
                                  cfg.head_channels, 3, 1, device=device,
                                  xavier=False, relu=False, stddev=0.0001)

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                tape=None) -> torch.Tensor:
        """In training, two independent dropout draws from ``generator``
        mask the fire11 halves before conv12.  ``tape`` (a dict, or None)
        receives each stage's activation under its layer name."""
        x = L.conv2d(self.conv1, images, 2, padding="VALID")
        L.record(tape, "conv1", x)
        pair = L.max_pool(x, 3, 2, "VALID")
        for name, _, _, _ in _FIRES:
            pool = (3, 2) if name in _POOL_AFTER else None
            pair = L.fire_pair(getattr(self, name), pair, pool=pool,
                               padding="VALID", tape=tape, name=name)
            L.record(tape, name, pair)
        pair = (L.dropout(pair[0], self.keep_prob, generator, train),
                L.dropout(pair[1], self.keep_prob, generator, train))
        out = L.conv2d_pair(self.conv12, pair[0], pair[1], 1, relu=False)
        L.record(tape, "conv12", out)
        return out
