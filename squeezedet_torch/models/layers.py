"""Layer library (counterpart of ``squeezedet_tpu/models/layers.py``).

Public functions keep the JAX package's NHWC layout.  Inside, an NHWC
tensor is viewed as NCHW with ``permute(0, 3, 1, 2)``: on a contiguous
NHWC tensor that view is an NCHW tensor in ``channels_last`` memory
format, which cuDNN convolves and pools without a copy, and whose
outputs come back ``channels_last`` so the reverse permute is free too.

Padding follows TF SAME (pad_top = pad_total // 2): on a stride-2 layer
with an even input it pads (0, 1), not torch's symmetric ``padding=1``.
Max-pool SAME pads with -inf.

Only the squeezeDet float inference path is ported here; int8,
``conv2d_s2d``, ``conv_bn``, fc, dropout and the custom filter-gradient
backward come with later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, k: int, s: int) -> Tuple[int, int, int]:
    """TF SAME along one dimension: (output size, pad before, pad after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, total // 2, total - total // 2


def _out_size(size: int, k: int, s: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // s)
    return -(-(size - k + 1) // s)


@dataclass
class NetTracer:
    """Walks static shapes through the net at construction and keeps the
    reference's per-layer parameter count."""

    height: int
    width: int
    channels: int
    model_size_counter: List[Tuple[str, int]] = field(default_factory=list)

    @classmethod
    def for_config(cls, cfg) -> "NetTracer":
        return cls(cfg.image_height, cfg.image_width, 3)

    def conv(self, name: str, filters: int, size: int, stride: int,
             padding: str) -> None:
        in_ch = self.channels
        self.height = _out_size(self.height, size, stride, padding)
        self.width = _out_size(self.width, size, stride, padding)
        self.channels = filters
        self.model_size_counter.append(
            (name, (1 + size * size * in_ch) * filters))

    def pool(self, name: str, size: int, stride: int, padding: str) -> None:
        self.height = _out_size(self.height, size, stride, padding)
        self.width = _out_size(self.width, size, stride, padding)

    def snapshot(self) -> Tuple[int, int, int]:
        return self.height, self.width, self.channels

    def restore(self, snap: Tuple[int, int, int]) -> None:
        self.height, self.width, self.channels = snap

    def total_params(self) -> int:
        return sum(p for _, p in self.model_size_counter)


class Conv(nn.Module):
    """Parameters of one conv layer: ``weight`` OIHW f32, ``bias`` [O]."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor,
                 freeze: bool = False):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=not freeze)
        self.bias = nn.Parameter(bias, requires_grad=not freeze)


def init_conv(generator: torch.Generator, tracer: NetTracer, name: str,
              filters: int, size: int, stride: int, *, device,
              padding: str = "SAME", freeze: bool = False,
              xavier: bool = False, stddev: float = 0.001) -> Conv:
    """A randomly initialised conv layer; advances ``tracer``.

    Xavier is the uniform Glorot of ``tf.contrib.layers.
    xavier_initializer_conv2d`` (fans include the receptive field);
    otherwise a normal clipped to 2 sigma.  Biases start at zero.  The
    draw happens on the CPU generator, so a seed gives the same weights
    on every device.
    """
    in_ch = tracer.channels
    shape = (filters, in_ch, size, size)
    if xavier:
        limit = math.sqrt(6.0 / (size * size * (in_ch + filters)))
        weight = torch.empty(shape).uniform_(-limit, limit,
                                             generator=generator)
    else:
        weight = torch.nn.init.trunc_normal_(
            torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
            generator=generator) * stddev
    tracer.conv(name, filters, size, stride, padding)
    return Conv(weight.to(device), torch.zeros(filters, device=device),
                freeze=freeze)


def _conv_nchw(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride: int,
               padding: str) -> torch.Tensor:
    """NHWC x, OIHW weight -> NCHW (channels_last) conv output, with the
    weight and bias cast to the activation dtype."""
    xc = x.permute(0, 3, 1, 2)
    pad = 0
    if padding == "SAME":
        _, pt, pb = same_padding(xc.shape[2], weight.shape[2], stride)
        _, pl, pr = same_padding(xc.shape[3], weight.shape[3], stride)
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
    return F.conv2d(xc, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=pad)


def conv2d(conv: Conv, x: torch.Tensor, stride: int, padding: str = "SAME",
           relu: bool = True) -> torch.Tensor:
    """NHWC conv + bias (+ relu), matching tf.nn.conv2d SAME/VALID."""
    y = _conv_nchw(x, conv.weight, conv.bias, stride, padding)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, size: int, stride: int,
             padding: str = "SAME") -> torch.Tensor:
    """tf.nn.max_pool on NHWC: SAME pads with -inf.

    Where TF pads one more after than before (a stride >1 pool over an
    even extent), torch's ``ceil_mode`` lets the last window run past the
    end by exactly that one element and ignores it, which equals the -inf
    pad without materialising a padded copy.
    """
    xc = x.permute(0, 3, 1, 2)
    pad, ceil_mode = 0, False
    if padding == "SAME":
        _, pt, pb = same_padding(xc.shape[2], size, stride)
        _, pl, pr = same_padding(xc.shape[3], size, stride)
        uneven = (pb - pt, pr - pl)
        if uneven == (0, 0):
            pad = (pt, pl)
        elif set(uneven) <= {0, 1} and size >= stride > 1 and \
                max(pt, pl) + 1 < size:
            pad, ceil_mode = (pt, pl), True
        else:
            xc = F.pad(xc, (pl, pr, pt, pb), value=-math.inf)
    y = F.max_pool2d(xc, size, stride, padding=pad, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


class Fire(nn.Module):
    """Fire module parameters: squeeze1x1 -> (expand1x1, expand3x3)."""

    def __init__(self, generator: torch.Generator, tracer: NetTracer,
                 name: str, s1x1: int, e1x1: int, e3x3: int, *, device,
                 stddev: float = 0.01, xavier: bool = False):
        super().__init__()
        kw = dict(device=device, stddev=stddev, xavier=xavier)
        self.squeeze1x1 = init_conv(generator, tracer, name + "/squeeze1x1",
                                    s1x1, 1, 1, **kw)
        snap = tracer.snapshot()
        self.expand1x1 = init_conv(generator, tracer, name + "/expand1x1",
                                   e1x1, 1, 1, **kw)
        tracer.restore(snap)
        self.expand3x3 = init_conv(generator, tracer, name + "/expand3x3",
                                   e3x3, 3, 1, **kw)
        tracer.channels = e1x1 + e3x3


def conv2d_pair(conv: Conv, xa: torch.Tensor, xb: torch.Tensor,
                stride: int = 1, relu: bool = True) -> torch.Tensor:
    """Conv over a virtual concat: conv(concat(xa, xb), k) ==
    conv(xa, k[:, :Ca]) + conv(xb, k[:, Ca:]), so fire outputs are never
    concatenated."""
    ca = xa.shape[-1]
    y = _conv_nchw(xa, conv.weight[:, :ca], conv.bias, stride, "SAME")
    y = y + _conv_nchw(xb, conv.weight[:, ca:], None, stride, "SAME")
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def fire_pair(fire: Fire, pair, *, pool=None, padding: str = "SAME"):
    """Fire module over (expand1x1, expand3x3) halves, returning halves.

    ``pair`` is a single tensor (first fire) or an (a, b) tuple; ``pool``
    optionally applies (size, stride) max-pooling to both halves, since
    pooling commutes with channel concatenation.
    """
    if isinstance(pair, tuple):
        sq = conv2d_pair(fire.squeeze1x1, pair[0], pair[1], 1)
    else:
        sq = conv2d(fire.squeeze1x1, pair, 1)
    a = conv2d(fire.expand1x1, sq, 1)
    b = conv2d(fire.expand3x3, sq, 1)
    if pool is not None:
        size, stride = pool
        a = max_pool(a, size, stride, padding)
        b = max_pool(b, size, stride, padding)
    return a, b
