"""Layer library (counterpart of ``squeezedet_tpu/models/layers.py``).

Public functions keep the JAX package's NHWC layout.  Inside, an NHWC
tensor is viewed as NCHW with ``permute(0, 3, 1, 2)``: on a contiguous
NHWC tensor that view is an NCHW tensor in ``channels_last`` memory
format, which cuDNN convolves and pools without a copy, and whose
outputs come back ``channels_last`` so the reverse permute is free too.

Padding follows TF SAME (pad_top = pad_total // 2): on a stride-2 layer
with an even input it pads (0, 1), not torch's symmetric ``padding=1``.
Max-pool SAME pads with -inf.

The float path of the four backbones is ported here, for inference and
training: conv, conv + frozen-statistics batch norm (ResNet), pools,
dropout, weight decay, and the filter-gradient routing that sends the
weight gradient of eligible stride-1 SAME convs through K2
(``ops/filter_grad.py``).  So is the int8 path of post-training
quantization (``quant.py``): :class:`QConv` layers, which ``conv2d``,
``conv2d_pair`` and ``conv_bn`` dispatch on as the JAX layers dispatch
on ``"mult" in params``, the float -> int8 boundary, and the int8
max-pool.  ``record`` fills the activation tape that calibration and
the quant report read.  fc (which no backbone uses) and the TPU-only
``conv2d_s2d`` are not ported.

Spatial partitioning: each layer function also takes a
:class:`~squeezedet_torch.models.halo.Tiled` activation (the frame as
height x width tiles, possibly on several devices) and then runs on
every tile's window (``halo.windowed``): VALID over the window, which is
padded only at the frame's edges.  Weights and buffers follow the
activation's device (``.to`` is free on their own device, and on another
one sums the gradient back into the parameter).  Such a forward never
routes K2: every conv over a tile window is VALID.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from squeezedet_torch.models import halo
from squeezedet_torch.models.halo import Tiled
from squeezedet_torch.ops.bn_act import bn_act


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
    reference's per-layer accounting (parameters, activations, FLOPs),
    which ``utils/metrics.write_model_metrics`` writes out."""

    height: int
    width: int
    channels: int
    model_size_counter: List[Tuple[str, int]] = field(default_factory=list)
    flop_counter: List[Tuple[str, int]] = field(default_factory=list)
    activation_counter: List[Tuple[str, int]] = field(default_factory=list)

    @classmethod
    def for_config(cls, cfg) -> "NetTracer":
        t = cls(cfg.image_height, cfg.image_width, 3)
        # the activation count starts with the input, as the reference's
        t.activation_counter.append(
            ("input", cfg.image_width * cfg.image_height * 3))
        return t

    def conv(self, name: str, filters: int, size: int, stride: int,
             padding: str, relu: bool = True) -> None:
        in_ch = self.channels
        self.height = _out_size(self.height, size, stride, padding)
        self.width = _out_size(self.width, size, stride, padding)
        self.channels = filters
        self.model_size_counter.append(
            (name, (1 + size * size * in_ch) * filters))
        flops = (1 + 2 * in_ch * size * size) * filters * self.height \
            * self.width
        if relu:
            flops += 2 * filters * self.height * self.width
        self.flop_counter.append((name, flops))
        self.activation_counter.append(
            (name, self.height * self.width * self.channels))

    def pool(self, name: str, size: int, stride: int, padding: str) -> None:
        self.height = _out_size(self.height, size, stride, padding)
        self.width = _out_size(self.width, size, stride, padding)
        self.activation_counter.append(
            (name, self.height * self.width * self.channels))

    def snapshot(self) -> Tuple[int, int, int]:
        return self.height, self.width, self.channels

    def restore(self, snap: Tuple[int, int, int]) -> None:
        self.height, self.width, self.channels = snap

    def total_params(self) -> int:
        return sum(p for _, p in self.model_size_counter)


class Conv(nn.Module):
    """Parameters of one conv layer: ``weight`` OIHW f32, ``bias`` [O].
    ``name`` is the layer's name in the tracer and in a caffe pickle."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor,
                 freeze: bool = False, name: str = ""):
        super().__init__()
        self.name = name
        self.weight = nn.Parameter(weight, requires_grad=not freeze)
        self.bias = nn.Parameter(bias, requires_grad=not freeze)


def init_conv(generator: torch.Generator, tracer: NetTracer, name: str,
              filters: int, size: int, stride: int, *, device,
              padding: str = "SAME", freeze: bool = False,
              xavier: bool = False, relu: bool = True,
              stddev: float = 0.001) -> Conv:
    """A randomly initialised conv layer; advances ``tracer``.

    Xavier is the uniform Glorot of ``tf.contrib.layers.
    xavier_initializer_conv2d`` (fans include the receptive field);
    otherwise a normal clipped to 2 sigma.  Biases start at zero.  The
    draw happens on the CPU generator, so a seed gives the same weights
    on every device.
    """
    weight = _init_weight(generator, (filters, tracer.channels, size, size),
                          xavier, stddev)
    tracer.conv(name, filters, size, stride, padding, relu)
    return Conv(weight.to(device), torch.zeros(filters, device=device),
                freeze=freeze, name=name)


def _init_weight(generator: torch.Generator, shape, xavier: bool,
                 stddev: float) -> torch.Tensor:
    """An OIHW weight drawn on the CPU generator: uniform Glorot (fans
    include the receptive field) or a normal clipped to 2 sigma."""
    filters, in_ch, size, _ = shape
    if xavier:
        limit = math.sqrt(6.0 / (size * size * (in_ch + filters)))
        return torch.empty(shape).uniform_(-limit, limit,
                                           generator=generator)
    return torch.nn.init.trunc_normal_(
        torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
        generator=generator) * stddev


def _conv_nchw(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride: int,
               padding: str) -> torch.Tensor:
    """NHWC x, OIHW weight -> NCHW (channels_last) conv output, with the
    weight and bias cast to the activation's dtype on its device."""
    xc = x.permute(0, 3, 1, 2)
    pad = 0
    if padding == "SAME":
        _, pt, pb = same_padding(xc.shape[2], weight.shape[2], stride)
        _, pl, pr = same_padding(xc.shape[3], weight.shape[3], stride)
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
    return F.conv2d(xc, weight.to(x.device, x.dtype),
                    None if bias is None else bias.to(x.device, x.dtype),
                    stride=stride, padding=pad)


# --- filter-gradient routing (K2) -----------------------------------------
#
# False: plain autograd (cuDNN's weight gradient on the card).  "1x1":
# stride-1 SAME 1x1 convs with C % 128 == 0 and H*W % 16 == 0 take their
# weight gradient from K2; the data gradient stays a transposed conv.
# True: also odd-sized kernels (3x3, 5x5) with C % 128 == 0.  The JAX
# package's modes and eligibility (squeezedet_tpu/models/layers.py:
# set_pallas_filter_grad, _pallas_dw_eligible); where it needs a TPU
# backend, here K2 launches its kernel on a CUDA tensor and runs its plain
# version on a CPU tensor.  One condition more than the JAX package's:
# K2's bf16 (tensor-core) route takes only O % 8 == 0, so a bf16 conv with
# other O stays on autograd.  Module-level, like the JAX switch: it
# applies to forwards run after it is set.
_FILTER_GRAD = False


def set_filter_grad(mode) -> None:
    """Route eligible convs' weight gradients through K2: False, "1x1"
    or True."""
    global _FILTER_GRAD
    if not (mode is False or mode is True or mode == "1x1"):
        raise ValueError("filter-grad mode must be False, '1x1' or True, "
                         "got {!r}".format(mode))
    _FILTER_GRAD = mode


def filter_grad_mode():
    """The current routing mode: False, "1x1" or True."""
    return _FILTER_GRAD


def filter_grad_eligible(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether a stride-1 SAME conv of NHWC ``x`` by OIHW ``weight``
    takes its weight gradient from K2 in the current mode."""
    _, c, kh, kw = weight.shape
    if not _FILTER_GRAD:
        return False
    if kh % 2 != 1 or kw % 2 != 1 or c % 128 != 0:
        return False
    if x.dtype == torch.bfloat16 and weight.shape[0] % 8 != 0:
        return False
    if _FILTER_GRAD == "1x1" and not (
            kh == kw == 1 and (x.shape[1] * x.shape[2]) % 16 == 0):
        return False
    return True


class _ConvS1Same(torch.autograd.Function):
    """Stride-1 SAME conv, no bias: NHWC x and OIHW weight (in x's dtype)
    -> NCHW (channels_last) output.  Backward: dX is the transposed conv
    (cuDNN on the card), dW comes from K2, in f32 cast to the weight's
    dtype, as the JAX custom VJP casts it to the kernel's."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return _conv_nchw(x, weight, None, 1, "SAME")

    @staticmethod
    def backward(ctx, g):
        from squeezedet_torch.ops.filter_grad import filter_grad
        x, weight = ctx.saved_tensors
        _, _, kh, kw = weight.shape
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the saved input (not torch.nn.grad.conv2d_input's expanded
            # stand-in) lets cuDNN see channels_last, as autograd's own
            # backward does: dX comes back channels_last, with no layout
            # copies here or in the ReLU/pool backward that consumes it
            dx = torch.ops.aten.convolution_backward(
                g, x.permute(0, 3, 1, 2), weight, None, [1, 1],
                [(kh - 1) // 2, (kw - 1) // 2], [1, 1], False, [0, 0], 1,
                [True, False, False])[0].permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = filter_grad(x.contiguous(),
                             g.permute(0, 2, 3, 1).contiguous(), kh, kw)
            dw = dw.permute(3, 2, 0, 1).to(weight.dtype)
        return dx, dw


def _conv_op(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor], stride: int,
             padding: str) -> torch.Tensor:
    """The conv (+ bias) as :func:`_conv_nchw` computes it, through the
    K2-backward Function when routed."""
    if stride == 1 and padding == "SAME" and \
            filter_grad_eligible(x, weight):
        y = _ConvS1Same.apply(x, weight.to(x.dtype))
        if bias is not None:
            y = y + bias.to(x.dtype).view(1, -1, 1, 1)
        return y
    return _conv_nchw(x, weight, bias, stride, padding)


def conv2d(conv, x: torch.Tensor, stride: int, padding: str = "SAME",
           relu: bool = True) -> torch.Tensor:
    """NHWC conv + bias (+ relu), matching tf.nn.conv2d SAME/VALID.  A
    :class:`QConv` layer takes the int8 path (:func:`qconv`)."""
    if isinstance(x, Tiled):
        return halo.windowed(
            [x], lambda w: conv2d(conv, w, stride, "VALID", relu),
            conv.weight.shape[2:], stride, padding, 0, conv.name)
    if isinstance(conv, QConv):
        return qconv(conv, [x], stride, padding, relu)
    y = _conv_op(x, conv.weight, conv.bias, stride, padding)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


# --- int8 (post-training quantization, quant.py) ----------------------------
#
# Symmetric int8 with zero-points of 0, so SAME zero padding and the
# virtual concat stay exact in the quantized domain.  The conv is an
# im2col GEMM through torch._int_mm (int8 x int8 -> int32, exact) on the
# CPU and the card alike: torch has no int8 conv, and the JAX package
# computes these convs with XLA, outside any Pallas kernel.  The epilogue
# is a multiply, then an add, then round and clamp, each rounding once as
# the JAX epilogue does, so the int8 activations of the card and the CPU
# are equal bit for bit.


def _round8(n: int) -> int:
    return -(-n // 8) * 8


class QConv(nn.Module):
    """An int8 conv layer (``quant.quantize_detector``): ``weight`` OIHW
    int8, per-output-channel f32 ``mult`` and ``bias`` with every scale
    folded in, and ``in_scale``, the scale at which a float input is
    quantized (the first int8 layer after float ones), or None.  Buffers
    all: a quantized detector serves and does not train.

    ``gemm_weight`` is ``weight`` as the [N, K] matrix of the im2col GEMM,
    taps in (dy, dx, c) order, with K and N zero-padded to multiples of 8
    (``torch._int_mm`` on the card takes no other; conv1's K is 27)."""

    def __init__(self, weight: torch.Tensor, mult: torch.Tensor,
                 bias: torch.Tensor, in_scale: Optional[float] = None,
                 name: str = ""):
        super().__init__()
        if weight.dtype != torch.int8:
            raise TypeError("QConv weight must be int8, got {}".format(
                weight.dtype))
        self.name = name
        device = weight.device
        self.register_buffer("weight", weight)
        self.register_buffer("mult", mult.to(device, torch.float32))
        self.register_buffer("bias", bias.to(device, torch.float32))
        self.register_buffer("in_scale", None if in_scale is None else
                             torch.tensor(float(in_scale), dtype=torch.float32,
                                          device=device))
        o, c, kh, kw = weight.shape
        k = kh * kw * c
        mat = torch.zeros((_round8(o), _round8(k)), dtype=torch.int8,
                          device=device)
        mat[:o, :k] = weight.permute(0, 2, 3, 1).reshape(o, k)
        self.register_buffer("gemm_weight", mat, persistent=False)


def quantize_activation(x: torch.Tensor, scale) -> torch.Tensor:
    """Float activation -> int8 at ``scale`` (an f32 scalar; symmetric,
    round half to even): ``clip(round(x * (1 / scale)), -128, 127)``, the
    reciprocal and the product in f32, as the JAX boundary computes them.
    Used at every float -> int8 boundary, for the input images and for
    ResNet's re-quantized block outputs."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    y = x.float() * (scale.new_ones(()) / scale)
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def _quant_boundary(conv: QConv, x: torch.Tensor) -> torch.Tensor:
    """int8 input of ``conv``: an int8 activation passes; a float one (the
    output of the last float layer) is quantized at ``conv.in_scale``."""
    if x.dtype == torch.int8:
        return x
    if conv.in_scale is None:
        raise ValueError("int8 layer {} got a {} input and has no in_scale "
                         "to quantize it".format(conv.name, x.dtype))
    return quantize_activation(x, conv.in_scale)


def im2col_int8(xs, kh: int, kw: int, stride: int, padding: str,
                k_cols: int):
    """NHWC int8 inputs -> the [B*Ho*Wo, k_cols] rows of an im2col GEMM:
    for each tap (dy, dx), the strided window of each input in turn, so
    that ``xs = [xa, xb]`` is the virtual concat of ``conv2d_pair``;
    columns past the taps are zero.  A stride-1 1x1 conv over one input
    with ``k_cols`` channels is the input itself, uncopied.  Returns the
    rows and (B, Ho, Wo)."""
    b, h, w, _ = xs[0].shape
    if padding == "SAME":
        ho, pt, pb = same_padding(h, kh, stride)
        wo, pl, pr = same_padding(w, kw, stride)
        if pt or pb or pl or pr:
            xs = [F.pad(x, (0, 0, pl, pr, pt, pb)) for x in xs]
    else:
        ho, wo = _out_size(h, kh, stride, padding), \
            _out_size(w, kw, stride, padding)
    cols = [x[:, dy:dy + (ho - 1) * stride + 1:stride,
              dx:dx + (wo - 1) * stride + 1:stride]
            for dy in range(kh) for dx in range(kw) for x in xs]
    k = sum(col.shape[-1] for col in cols)
    if k_cols > k:
        cols.append(cols[0].new_zeros((b, ho, wo, k_cols - k)))
    rows = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return rows.reshape(b * ho * wo, k_cols), (b, ho, wo)


def _int_mm(rows: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [N, K]^T int8 -> [M, N] int32 (exact).  The card's
    ``_int_mm`` takes only M > 16, so smaller M is padded with zero rows."""
    m = rows.shape[0]
    if m <= 16:
        rows = F.pad(rows, (0, 0, 0, 17 - m))
    return torch._int_mm(rows, mat.t())[:m]


def qconv(conv: QConv, xs, stride: int, padding: str = "SAME",
          relu: bool = True) -> torch.Tensor:
    """The int8 conv of ``conv`` over the virtual concat of NHWC ``xs``
    (each int8, or float and quantized at ``conv.in_scale``): the int32
    accumulator, then ``acc * mult + bias`` in f32.  With ``relu`` the
    result is re-quantized, ``clip(round(max(y, 0)), 0, 127)`` as int8;
    without (the ConvDet head, ResNet's branch2c and projection
    shortcuts) it stays f32.  Returns NHWC."""
    xs = [_quant_boundary(conv, x) for x in xs]
    dev = xs[0].device
    o, _, kh, kw = conv.weight.shape
    rows, (b, ho, wo) = im2col_int8(xs, kh, kw, stride, padding,
                                    conv.gemm_weight.shape[1])
    acc = _int_mm(rows, conv.gemm_weight.to(dev))
    y = (acc if acc.shape[1] == o else acc[:, :o]).float()
    y.mul_(conv.mult.to(dev))  # in place, then in place: two roundings
    y.add_(conv.bias.to(dev))
    if relu:
        y = torch.clamp_(torch.round_(torch.clamp_(y, min=0.0)), 0, 127) \
            .to(torch.int8)
    return y.reshape(b, ho, wo, o)


def record(tape, name: str, activation) -> None:
    """Store a layer activation in ``tape`` (a dict, or a mapping that
    reduces what it is given, as calibration's does) under ``name``; no-op
    when tape is None.  Concat-free fire pairs are stored as their
    concat, and a tiled activation as the frame on its home device."""
    if tape is None:
        return
    if isinstance(activation, tuple):
        activation = tuple(a.gather() if isinstance(a, Tiled) else a
                           for a in activation)
    elif isinstance(activation, Tiled):
        activation = activation.gather()
    if isinstance(activation, tuple):
        activation = torch.cat(activation, dim=-1)
    tape[name] = activation


# --- conv + frozen-statistics batch norm (ResNet) ---------------------------


class ConvBN(nn.Module):
    """A conv and its frozen-statistics batch norm: ``weight`` OIHW, an
    optional ``bias`` (ResNet's conv1 only), ``gamma`` and ``beta``
    (parameters, trained unless the layer is frozen) and ``mean`` and
    ``var`` (persistent buffers: never trained, carried by state_dict
    and checkpoints).  ``name``, ``bn_name`` and ``scale_name`` are the
    caffe pickle's entries for [kernel (, bias)], [mean, var] and
    [gamma, beta]."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 filters: int, *, freeze: bool = False, name: str = "",
                 bn_name: str = "", scale_name: str = ""):
        super().__init__()
        self.name, self.bn_name, self.scale_name = name, bn_name, scale_name
        device = weight.device
        self.weight = nn.Parameter(weight, requires_grad=not freeze)
        self.bias = None if bias is None else \
            nn.Parameter(bias, requires_grad=not freeze)
        self.gamma = nn.Parameter(torch.ones(filters, device=device),
                                  requires_grad=not freeze)
        self.beta = nn.Parameter(torch.zeros(filters, device=device),
                                 requires_grad=not freeze)
        self.register_buffer("mean", torch.zeros(filters, device=device))
        self.register_buffer("var", torch.ones(filters, device=device))


def init_conv_bn(generator: torch.Generator, tracer: NetTracer, name: str,
                 filters: int, size: int, stride: int, *, device,
                 bn_name: str, scale_name: str, freeze: bool = False,
                 relu: bool = True,
                 conv_with_bias: bool = False, stddev: float = 0.001,
                 xavier: bool = False) -> ConvBN:
    """A randomly initialised :class:`ConvBN` (weight as in
    :func:`init_conv`; zero bias; identity batch norm: mean 0, var 1,
    gamma 1, beta 0); advances ``tracer``."""
    weight = _init_weight(generator, (filters, tracer.channels, size, size),
                          xavier, stddev)
    tracer.conv(name, filters, size, stride, "SAME", relu)
    bias = torch.zeros(filters, device=device) if conv_with_bias else None
    return ConvBN(weight.to(device), bias, filters, freeze=freeze, name=name,
                  bn_name=bn_name, scale_name=scale_name)


class PendingBN(NamedTuple):
    """A conv's raw output ``y`` (NCHW, channels_last) whose conv bias and
    batch norm, ``layer``'s, are still to apply: :func:`join` applies
    them in the pass that joins it."""

    y: torch.Tensor
    layer: ConvBN


def conv_bn(layer, x: torch.Tensor, stride: int, *,
            relu: bool = True, eps: float = 1e-5,
            padding: str = "SAME", pending: bool = False):
    """NHWC SAME conv (+ bias), then the frozen-statistics batch norm as an
    affine, gamma * (y - mean) / sqrt(var + eps) + beta, in the JAX
    package's arithmetic: ``inv = gamma * rsqrt(var + eps)`` in f32, then
    ``y * inv + (beta - mean * inv)`` with both terms cast to y's dtype,
    each op rounding to it.  ``ops/bn_act.bn_act`` applies it (and the
    ReLU): on the card, in one pass of K4 where ``bn_act.takes`` the call
    (a ReLU'd layer in scoring; in training, the frozen ones); else its
    plain version, ``bn_act_reference``, in those torch ops.  With
    ``pending`` (and no ``relu``), the conv's raw output as a
    :class:`PendingBN`, for :func:`join` to finish.  Never routed through
    K2, as the JAX conv_bn calls its conv directly.  A :class:`QConv` (the
    batch norm folded into it at quantize time, ``quant._fold_bn``) takes
    the int8 path, and a tiled ``x`` runs tile by tile, each tile a whole
    ``conv_bn``; neither is ever pending."""
    if isinstance(x, Tiled):
        return halo.windowed(
            [x], lambda w: conv_bn(layer, w, stride, relu=relu, eps=eps,
                                   padding="VALID"),
            layer.weight.shape[2:], stride, padding, 0, layer.name)
    if isinstance(layer, QConv):
        return qconv(layer, [x], stride, padding, relu)
    y = _conv_nchw(x, layer.weight, None, stride, padding)
    if pending:
        return PendingBN(y, layer)
    return bn_act(y, layer, eps, relu=relu).permute(0, 2, 3, 1)


def join(shortcut, y, eps: float = 1e-5) -> torch.Tensor:
    """A residual block's join, relu(shortcut + y), NHWC.  Both operands
    NHWC tensors (an int8 block's, a tile's), or ``y`` a
    :class:`PendingBN` of :func:`conv_bn` and the shortcut an NHWC tensor
    (the identity) or pending too (a projection): then one ``bn_act``
    call (one launch of K4 on the card) applies their batch norms, the
    add and the ReLU."""
    if not isinstance(y, PendingBN):
        return F.relu(shortcut + y)
    if isinstance(shortcut, PendingBN):
        s, s_layer = shortcut.y, shortcut.layer
    else:
        s, s_layer = shortcut.permute(0, 3, 1, 2), None
    return bn_act(y.y, y.layer, eps, relu=True, shortcut=s,
                  shortcut_layer=s_layer).permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, size: int, stride: int,
             padding: str = "SAME") -> torch.Tensor:
    """tf.nn.max_pool on NHWC: SAME pads with -inf.

    Where TF pads one more after than before (a stride >1 pool over an
    even extent), torch's ``ceil_mode`` lets the last window run past the
    end by exactly that one element and ignores it, which equals the -inf
    pad without materialising a padded copy.

    An int8 tensor is pooled in bf16, which holds -128..127 exactly (the
    card's max-pool takes no integer type), and cast back: the same max.
    A tiled activation's windows are padded with the dtype's lowest value
    at the frame's edges, which no window's max can take.
    """
    if isinstance(x, Tiled):
        return halo.windowed(
            [x], lambda w: max_pool(w, size, stride, "VALID"), size, stride,
            padding, halo.lowest(x.dtype), "max_pool")
    if x.dtype == torch.int8:
        return max_pool(x.to(torch.bfloat16), size, stride,
                        padding).to(torch.int8)
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


class BatchRows(NamedTuple):
    """A dropout generator for rows ``[start, start + B)`` of a
    ``global_batch`` batch: each mask is drawn for the whole batch and
    the rows kept, so a data-parallel rank masks its rows as one device
    running the global batch masks them, and the ranks' generators stay
    in step."""

    generator: torch.Generator
    global_batch: int
    start: int


def dropout(x: torch.Tensor, keep_prob: float,
            generator: Union[torch.Generator, BatchRows, None],
            train: bool) -> torch.Tensor:
    """Inverted dropout: keep each element with probability keep_prob and
    scale the kept ones by 1/keep_prob.

    When keep_prob is q/256 (0.5 is), one uint8 per element is drawn and
    kept where it is below q, as the JAX layer draws it; otherwise one
    f32 uniform per element.  ``generator`` lives on x's device; the two
    frameworks draw different bits from a seed.  A :class:`BatchRows`
    draws for its global batch.  A tiled activation's mask is drawn for
    the whole frame on its home device (the generator's) and each tile
    keeps its part, so the tiles mask as the whole frame is masked.
    """
    if not train or keep_prob >= 1.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator on "
                         "the activations' device")
    tiled = isinstance(x, Tiled)
    batch = x.batch if tiled else x.shape[0]
    shape = (batch, x.height, x.width, x.tiles[0][0].shape[3]) if tiled \
        else tuple(x.shape)
    rows = None
    if isinstance(generator, BatchRows):
        rows = slice(generator.start, generator.start + batch)
        shape = (generator.global_batch,) + shape[1:]
        generator = generator.generator
    device = x.home if tiled else x.device
    q = round(keep_prob * 256)
    if 0 < q < 256 and abs(q - keep_prob * 256) < 1e-9:
        bits = torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=device, generator=generator)
        keep = bits < q
    else:
        keep = torch.rand(shape, device=device,
                          generator=generator) < keep_prob
    if rows is not None:
        keep = keep[rows]
    if not tiled:
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
    out = [[None] * (len(x.cols) - 1) for _ in range(len(x.rows) - 1)]
    for i, j in x.indices():
        t = x.tiles[i][j]
        k = keep[:, x.rows[i]:x.rows[i + 1], x.cols[j]:x.cols[j + 1]]
        out[i][j] = torch.where(k.to(t.device), t / keep_prob,
                                torch.zeros_like(t))
    return Tiled(out, x.rows, x.cols, x.home)


def pointwise(fn, *xs):
    """``fn(*xs)`` for elementwise ``fn``: tile by tile when the inputs
    are tiled (alike), else on the tensors."""
    if isinstance(xs[0], Tiled):
        return xs[0].map(fn, *xs[1:])
    return fn(*xs)


def weight_decay_loss(module: nn.Module, wd: float):
    """wd * 0.5 * ||W||^2 in f32, summed over the conv weights of
    ``module`` that train (requires_grad); frozen layers and biases
    carry no decay."""
    total = 0.0
    for name, p in module.named_parameters():
        if name.endswith("weight") and p.requires_grad:
            total = total + wd * 0.5 * torch.sum(torch.square(p.float()))
    return total


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


def conv2d_pair(conv, xa: torch.Tensor, xb: torch.Tensor,
                stride: int = 1, relu: bool = True,
                padding: str = "SAME") -> torch.Tensor:
    """Conv over a virtual concat: conv(concat(xa, xb), k) ==
    conv(xa, k[:, :Ca]) + conv(xb, k[:, Ca:]), so fire outputs are never
    concatenated.  A :class:`QConv` takes both halves' taps into one
    int32 accumulator, which equals the JAX package's sum of two."""
    if isinstance(xa, Tiled):
        return halo.windowed(
            [xa, xb], lambda a, b: conv2d_pair(conv, a, b, stride, relu,
                                               "VALID"),
            conv.weight.shape[2:], stride, padding, 0, conv.name)
    if isinstance(conv, QConv):
        return qconv(conv, [xa, xb], stride, padding, relu)
    ca = xa.shape[-1]
    y = _conv_op(xa, conv.weight[:, :ca], conv.bias, stride, padding)
    y = y + _conv_op(xb, conv.weight[:, ca:], None, stride, padding)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def fire_pair(fire: Fire, pair, *, pool=None, padding: str = "SAME",
              tape=None, name: str = ""):
    """Fire module over (expand1x1, expand3x3) halves, returning halves.

    ``pair`` is a single tensor (first fire) or an (a, b) tuple; ``pool``
    optionally applies (size, stride) max-pooling to both halves, since
    pooling commutes with channel concatenation.  With a ``tape``, the
    squeeze output is recorded as ``<name>/squeeze1x1``.
    """
    if isinstance(pair, tuple):
        sq = conv2d_pair(fire.squeeze1x1, pair[0], pair[1], 1)
    else:
        sq = conv2d(fire.squeeze1x1, pair, 1)
    if name:
        record(tape, name + "/squeeze1x1", sq)
    a = conv2d(fire.expand1x1, sq, 1)
    b = conv2d(fire.expand3x3, sq, 1)
    if pool is not None:
        size, stride = pool
        a = max_pool(a, size, stride, padding)
        b = max_pool(b, size, stride, padding)
    return a, b
