"""SqueezeDet backbone + ConvDet head (counterpart of
``squeezedet_tpu/models/squeezedet.py``).

conv1 (64f 3x3 s2, frozen) -> pool1 -> fire2..3 -> pool3 -> fire4..5 ->
pool5 -> fire6..9 -> fire10..11 -> dropout (training) -> conv12 ConvDet
head with
APG*(C+1+4) channels, 3x3, no relu, stddev 1e-4.  All pools are 3x3
stride-2 SAME; overall stride 16.  A float conv1+pool1 runs through the
K1 wrapper (:func:`squeezedet_torch.ops.fused_frontend.conv1_pool1`),
the CUDA kernel on the card and its plain version on the CPU, unless an
activation tape asks for conv1's output before the pool, which K1 never
exposes.  On a tiled frame (``models.halo.Tiled``) K1 launches once per
tile that owns a pool output, at the tile's own geometry
(:func:`conv1_pool1`).  An int8 conv1 (``quant.py``, whole-net int8) is a
``layers.QConv`` and the int8 max-pool, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from squeezedet_torch.models import halo
from squeezedet_torch.models import layers as L
from squeezedet_torch.ops import fused_frontend

# (name, s1x1, e1x1, e3x3) for fire2..fire11.
_FIRES = [
    ("fire2", 16, 64, 64), ("fire3", 16, 64, 64),
    ("fire4", 32, 128, 128), ("fire5", 32, 128, 128),
    ("fire6", 48, 192, 192), ("fire7", 48, 192, 192),
    ("fire8", 64, 256, 256), ("fire9", 64, 256, 256),
    ("fire10", 96, 384, 384), ("fire11", 96, 384, 384),
]
# pools come after these layers
_POOL_AFTER = {"conv1": "pool1", "fire3": "pool3", "fire5": "pool5"}


def conv1_pool1(images, kernel: torch.Tensor, bias: torch.Tensor):
    """K1 (:func:`fused_frontend.conv1_pool1`) over the frame, or once
    per tile of a ``halo.Tiled`` frame: each tile's pool outputs (the
    frame's bounds through the conv and the pool, ``halo.next_bounds``)
    from its input window at its own geometry
    (:func:`fused_frontend.tile_geometry`)."""
    if not isinstance(images, halo.Tiled):
        return fused_frontend.conv1_pool1(images, kernel, bias)
    x = images
    hc, wc, hp, wp = fused_frontend.geometry(x.height, x.width)[:4]
    rows = halo.next_bounds(halo.next_bounds(x.rows, 2, hc), 2, hp)
    cols = halo.next_bounds(halo.next_bounds(x.cols, 2, wc), 2, wp)

    def tile(i, j, q, p):
        (r, c), geo = fused_frontend.tile_geometry(x.height, x.width, q, p)
        win = x.window(i, j, r[0], r[1], c[0], c[1]).contiguous()
        if win.data_ptr() % 16:  # the bf16 route's 16-byte loads
            win = win.clone()
        dev = win.device
        return fused_frontend.conv1_pool1(win, kernel.to(dev), bias.to(dev),
                                          list(geo))
    return halo.tile_op(x, rows, cols, tile, "conv1_pool1")


class SqueezeDet(nn.Module):
    """Backbone + head parameters; ``forward`` maps [B, H, W, 3] BGR
    mean-subtracted images to ConvDet preds [B, Hg, Wg, APG*(C+5)], both
    NHWC, in the images' dtype."""

    def __init__(self, cfg, *, device, generator: torch.Generator):
        super().__init__()
        self.keep_prob = cfg.keep_prob
        self.tracer = L.NetTracer.for_config(cfg)
        xavier = cfg.scratch_init == "xavier"
        self.conv1 = L.init_conv(generator, self.tracer, "conv1", 64, 3, 2,
                                 device=device, freeze=True, xavier=xavier)
        self.tracer.pool("pool1", 3, 2, "SAME")
        for name, s, e1, e3 in _FIRES:
            self.add_module(name, L.Fire(generator, self.tracer, name, s, e1,
                                         e3, device=device, xavier=xavier))
            if name in _POOL_AFTER:
                self.tracer.pool(_POOL_AFTER[name], 3, 2, "SAME")
        self.conv12 = L.init_conv(generator, self.tracer, "conv12",
                                  cfg.head_channels, 3, 1, device=device,
                                  xavier=False, relu=False, stddev=0.0001)

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                tape=None) -> torch.Tensor:
        """In training, two independent dropout draws from ``generator``
        mask the fire11 halves before conv12.  ``tape`` (a dict, or None)
        receives each stage's activation under its layer name, conv1's
        before pool1, as the JAX backbone records them."""
        if tape is None and not isinstance(self.conv1, L.QConv):
            x = conv1_pool1(images, self.conv1.weight.permute(2, 3, 1, 0),
                            self.conv1.bias)
        else:
            x = L.conv2d(self.conv1, images, 2)
            L.record(tape, "conv1", x)
            x = L.max_pool(x, 3, 2, "SAME")
        pair = x
        for name, _, _, _ in _FIRES:
            pool = (3, 2) if name in _POOL_AFTER else None
            pair = L.fire_pair(getattr(self, name), pair, pool=pool,
                               tape=tape, name=name)
            L.record(tape, name, pair)
        pair = (L.dropout(pair[0], self.keep_prob, generator, train),
                L.dropout(pair[1], self.keep_prob, generator, train))
        out = L.conv2d_pair(self.conv12, pair[0], pair[1], 1, relu=False)
        L.record(tape, "conv12", out)
        return out
