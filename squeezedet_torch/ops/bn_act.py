"""ResNet's conv + frozen batch-norm epilogue in one pass (K4).

:func:`bn_act` finishes a raw conv output with its layer's conv bias
(if any) and frozen-statistics batch norm as an affine, then a ReLU, a
residual join, ``relu(s + t)``, where the shortcut ``s`` is the identity
or a projection's raw conv output with that layer's own affine, or
nothing.  On CUDA tensors that :func:`takes` it is one launch of the
hand-written kernel in ``csrc/bn_act.cu``, a streaming pass over the
channels-last map that computes each layer's scale and shift itself and
writes its result over the conv's output; its results equal the plain
version's (:func:`bn_act_reference`, the torch ops it replaces) bit for
bit on the card, in bf16 and f32.  K4 replaces no TPU kernel: the JAX
package's ``conv_bn`` and join are plain jnp, and the port's torch ops
were 72 % of a ResNet50 scoring call (the source's note).

Every other call runs the plain version: CPU tensors, dtypes other than
bf16 and f32, maps that are not channels-last contiguous or whose
channels are not a multiple of 8, calls without a ReLU (a spatial tile's
branch2c or branch1, whose join is a separate add), calls that autograd
has to see through (a parameter or input that requires grad, under grad
mode), and calls traced by ``torch.export`` or ``torch.compile``.  A
call the kernel takes launches it or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from squeezedet_torch.ops import _cuda

# Kernel launches by :func:`bn_act` in this process.
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/bn_act.cu's shortcut forms
NO_SHORTCUT, IDENTITY, PROJECTION = 0, 1, 2
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 5 + [ctypes.c_float]
             + [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p])


def _affine_reference(y: torch.Tensor, layer, eps: float) -> torch.Tensor:
    """y (+ bias), then the batch norm in the JAX package's arithmetic:
    ``inv = gamma * rsqrt(var + eps)`` and ``shift = beta - mean * inv``
    in f32 on the parameters' device, each cast to y's dtype."""
    dev, dt = y.device, y.dtype
    if layer.bias is not None:
        y = y + layer.bias.to(dev, dt).view(1, -1, 1, 1)
    inv = layer.gamma * torch.rsqrt(layer.var + eps)
    shift = layer.beta - layer.mean * inv
    return y * inv.to(dev, dt).view(1, -1, 1, 1) + \
        shift.to(dev, dt).view(1, -1, 1, 1)


def bn_act_reference(y: torch.Tensor, layer, eps: float, *, relu: bool,
                     shortcut: Optional[torch.Tensor] = None,
                     shortcut_layer=None) -> torch.Tensor:
    """The plain version of :func:`bn_act`, in torch ops: each rounds its
    result to y's dtype, and the scale and shift are cast to it."""
    t = _affine_reference(y, layer, eps)
    if shortcut is not None:
        s = shortcut if shortcut_layer is None else \
            _affine_reference(shortcut, shortcut_layer, eps)
        t = s + t
    return F.relu(t) if relu else t


def _norm_tensors(layer):
    return [t for t in (layer.bias, layer.gamma, layer.beta, layer.mean,
                        layer.var) if t is not None]


def _map_ok(t: torch.Tensor, like: torch.Tensor) -> bool:
    return (t.dim() == 4 and t.shape == like.shape and t.dtype == like.dtype
            and t.device == like.device
            and t.permute(0, 2, 3, 1).is_contiguous()
            and t.data_ptr() % 16 == 0)


def takes(y: torch.Tensor, layer, *, relu: bool,
          shortcut: Optional[torch.Tensor] = None,
          shortcut_layer=None) -> bool:
    """Whether K4 takes :func:`bn_act`'s call: maps on CUDA that
    :func:`fits`, outside a trace by ``torch.export`` or
    ``torch.compile`` (the kernel reads real memory)."""
    return (y.device.type == "cuda" and not torch.compiler.is_compiling()
            and fits(y, layer, relu=relu, shortcut=shortcut,
                     shortcut_layer=shortcut_layer))


def fits(y: torch.Tensor, layer, *, relu: bool,
         shortcut: Optional[torch.Tensor] = None,
         shortcut_layer=None) -> bool:
    """Whether the kernel takes these operands, on whatever device: a
    call that ends in ReLU; bf16 or f32 maps, NCHW views of channels-last
    contiguous memory starting on a 16-byte boundary, with a multiple of
    8 channels; each layer's batch-norm vectors f32 and contiguous on the
    map's device, a conv bias only without a shortcut; nothing that
    autograd has to see through."""
    if not relu or y.dtype not in _DTYPES or y.dim() != 4 or \
            y.shape[1] % 8 or not _map_ok(y, y):
        return False
    if shortcut is not None and (not _map_ok(shortcut, y)
                                 or layer.bias is not None):
        return False
    if shortcut_layer is not None and shortcut_layer.bias is not None:
        return False
    layers = [layer] if shortcut_layer is None else [layer, shortcut_layer]
    vectors = [t for lay in layers for t in _norm_tensors(lay)]
    if any(t.dtype != torch.float32 or t.device != y.device
           or t.shape != (y.shape[1],) or not t.is_contiguous()
           for t in vectors):
        return False
    maps = [y] if shortcut is None else [y, shortcut]
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in maps + vectors))


def bn_act(y: torch.Tensor, layer, eps: float, *, relu: bool,
           shortcut: Optional[torch.Tensor] = None,
           shortcut_layer=None) -> torch.Tensor:
    """``y``, a raw conv output [B, C, H, W] (NCHW, channels_last),
    finished with ``layer``'s conv bias and batch norm (``bias`` or None,
    ``gamma``, ``beta``, ``mean``, ``var``, ``eps``); with ``shortcut``
    (same shape and dtype) the join ``shortcut + t``, where a given
    ``shortcut_layer`` first applies its own batch norm to the shortcut;
    then ReLU where ``relu``.  K4 where :func:`takes` says so, writing
    its result over ``y`` and returning ``y``; else the plain version."""
    global LAUNCHES
    if not takes(y, layer, relu=relu, shortcut=shortcut,
                 shortcut_layer=shortcut_layer):
        return bn_act_reference(y, layer, eps, relu=relu, shortcut=shortcut,
                                shortcut_layer=shortcut_layer)
    form = NO_SHORTCUT if shortcut is None else \
        IDENTITY if shortcut_layer is None else PROJECTION
    b, c, h, w = y.shape
    # the shortcut's vectors: unread but for a projection
    sl = layer if shortcut_layer is None else shortcut_layer
    fn = _cuda.function("bn_act", "sdt_bn_act", _ARGTYPES)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(y.data_ptr(), y.data_ptr(),
                 None if shortcut is None else shortcut.data_ptr(),
                 b * h * w, c, _DTYPES[y.dtype], form,
                 None if layer.bias is None else layer.bias.data_ptr(),
                 layer.gamma.data_ptr(), layer.beta.data_ptr(),
                 layer.mean.data_ptr(), layer.var.data_ptr(), eps,
                 sl.gamma.data_ptr(), sl.beta.data_ptr(), sl.mean.data_ptr(),
                 sl.var.data_ptr(), eps, stream)
    _cuda.check("bn_act", err, "bn_act kernel launch")
    LAUNCHES += 1
    return y
