"""Post-training int8 quantization (counterpart of
``squeezedet_tpu/quant.py``).

Scheme, as in the JAX package:

- **Weights**: per-output-channel symmetric int8,
  ``s_w[o] = max|W[..., o]| / 127``.
- **Activations**: per-tensor symmetric int8, scales calibrated as the
  abs-max (or a percentile) of the float model's activation tape over
  calibration batches.
- **Input**: ``s_in`` is the exact bound of ``uint8 - bgr_mean``
  (max(mean, 255 - mean) over channels), so input quantization never
  clips.
- **Folding**: each conv's scales fold offline into one per-channel f32
  multiplier and bias (``y8 = clip(round(max(acc*m + b, 0)), 0, 127)``);
  the ConvDet head dequantizes to f32 instead.
- **Zero-points are all zero**, so SAME zero padding and the virtual
  concat of the fire chain stay exact.

:func:`quantize_detector` computes the JAX package's quantized tree with
the same numpy arithmetic, from the float detector's weights in the JAX
layout, so its int8 kernels equal the JAX ones bit for bit; then
``weights.from_jax_qparams`` builds a new :class:`Detector` from it, whose
quantized convs are ``layers.QConv`` and whose input scale (whole-net
mode only) is the buffer ``input_scale``.  The float detector is left as
it was.  The int8 convs run as im2col GEMMs (``layers.qconv``).

Supported nets: squeezeDet, squeezeDet+ (fire chains), vgg16 (conv
chain), resnet50 (frozen-statistics batch norm folded into the int8
convs; the residual joins run in f32 and re-quantize at the block's
calibrated scale).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from squeezedet_torch.data.device_pipeline import normalize_images
from squeezedet_torch.models.layers import quantize_activation

Scales = Dict[str, float]

#: key of the input quantization scale in the JAX-layout quantized tree
#: (``weights.from_jax_qparams`` turns it into ``Detector.input_scale``)
INPUT_SCALE_KEY = "__input_scale__"


def input_scale(bgr_means) -> float:
    """Exact abs-bound of ``uint8 - bgr_mean``, as an int8 scale."""
    m = np.asarray(bgr_means, np.float64).reshape(-1)
    return float(max(m.max(), 255.0 - m.min()) / 127.0)


def quantize_images(images_u8: torch.Tensor, bgr_means,
                    scale) -> torch.Tensor:
    """uint8 BGR [B, H, W, 3] -> int8 in the model's input domain: the
    mean subtraction in f32 (``normalize_images``), then the boundary
    quantization.  With ``scale = input_scale(bgr_means)`` nothing clips
    and the rounding error is at most scale/2."""
    return quantize_images_normalized(
        normalize_images(images_u8, bgr_means, torch.float32), scale)


def quantize_images_normalized(images_f: torch.Tensor,
                               scale) -> torch.Tensor:
    """Mean-subtracted float images (the eval and demo readers' format) ->
    int8 input domain, by the formula of every activation boundary
    (``layers.quantize_activation``)."""
    return quantize_activation(images_f, scale)


def percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """numpy's "linear" percentile of a 1-D f32 tensor in the f32
    arithmetic of ``jnp.percentile`` (its default method), from the two
    order statistics around the position ``q/100 * (n-1)``: the position
    and its weights in f32, then ``low * w_low + high * w_high``.
    ``torch.quantile`` takes at most 2**24 elements; a sort takes any."""
    f32 = np.float32
    n = a.numel()
    pos = f32(f32(q) / f32(100.0)) * f32(f32(n) - f32(1.0))
    low = min(max(int(np.floor(pos)), 0), n - 1)
    high = min(max(int(np.ceil(pos)), 0), n - 1)
    w_high = f32(pos - f32(np.floor(pos)))
    w_low = f32(f32(1.0) - w_high)
    ordered = torch.sort(a.float()).values
    return ordered[low] * float(w_low) + ordered[high] * float(w_high)


class _Reducer(dict):
    """An activation tape that keeps, for each layer, one f32 scalar on
    the device: max |activation|, or its ``q``-th percentile (abs-max
    where that percentile is 0, as post-ReLU tensors are mostly zeros and
    a low percentile lands on them).  Full-size calibration so never
    holds more than one activation per layer at a time."""

    def __init__(self, q: Optional[float]):
        super().__init__()
        self.q = q

    def __setitem__(self, name, activation):
        a = activation.float().abs()
        top = a.max()
        if self.q is not None:
            p = percentile(a.reshape(-1), self.q)
            top = torch.where(p > 0, p, top)
        super().__setitem__(name, top)


def calibrate_normalized(det, batches_f: Iterable,
                         percentile: Optional[float] = None) -> Scales:
    """Per-layer activation ranges of the float ``det`` over
    mean-subtracted float batches, on its device: each batch runs the
    taped forward in the compute dtype and is reduced per layer (abs-max,
    or the ``percentile`` of |activation|), then max-combined across
    batches on the host."""
    device = det.anchors.device
    out: Scales = {}
    n = 0
    for x in batches_f:
        tape = _Reducer(percentile)
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        with torch.inference_mode():
            det.backbone(x.to(device, det.compute_dtype).contiguous(),
                         tape=tape)
        for k, v in tape.items():
            out[k] = max(out.get(k, 0.0), float(v))
        n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return out


def calibrate(det, batches_u8: Iterable,
              percentile: Optional[float] = None) -> Scales:
    """:func:`calibrate_normalized` over uint8 batches, mean-subtracted in
    f32 on the device first."""
    device = det.anchors.device

    def normalized():
        for u8 in batches_u8:
            u8 = torch.as_tensor(np.asarray(u8) if not torch.is_tensor(u8)
                                 else u8)
            yield normalize_images(u8.to(device), det.cfg.bgr_means,
                                   torch.float32)

    return calibrate_normalized(det, normalized(), percentile=percentile)


# --- the quantized tree, in the JAX package's layout and arithmetic ---------


def _quantize_conv(layer: dict, s_in: float,
                   s_out: Optional[float]) -> dict:
    """Quantize one conv layer's params (HWIO kernel), folding scales.
    ``s_out=None`` marks a layer whose epilogue dequantizes to f32 (the
    ConvDet head, ResNet's branch2c and projection shortcuts)."""
    w = np.asarray(layer["kernel"], np.float32)
    b = np.asarray(layer["bias"], np.float32)
    s_w = np.abs(w).max(axis=(0, 1, 2)) / 127.0
    s_w = np.maximum(s_w, 1e-30)  # all-zero channels quantize to zeros
    k_q = np.clip(np.rint(w / s_w), -127, 127).astype(np.int8)
    if s_out is None:
        mult = (s_in * s_w).astype(np.float32)
        bias = b.astype(np.float32)
    else:
        mult = (s_in * s_w / s_out).astype(np.float32)
        bias = (b / s_out).astype(np.float32)
    return {"kernel": k_q, "mult": mult, "bias": bias}


def _act_scale(scales: Scales, name: str) -> float:
    absmax = scales[name]
    if not absmax > 0.0:
        raise ValueError("activation {} is identically zero in "
                         "calibration".format(name))
    return absmax / 127.0


def _quantize_fire_chain(mod, params, scales: Scales, s_input: float,
                         head: str, start: str) -> dict:
    """squeezeDet / squeezeDet+: conv1 -> fire2..11 -> head.  Pools are
    scale-invariant, so each layer's input scale is its producer's output
    scale; both expand halves share the fire's scale.  Layers before
    ``start`` stay float, and the first int8 squeeze carries
    ``in_scale``."""
    q = {}
    quantizing = start == "conv1"
    s_prev = _act_scale(scales, "conv1")
    if quantizing:
        q["conv1"] = _quantize_conv(params["conv1"], s_input, s_prev)
        boundary = {}
    else:
        q["conv1"] = dict(params["conv1"])
        boundary = {"in_scale": np.float32(s_prev)}
    for name, _, _, _ in mod._FIRES:
        if not quantizing and name == start:
            quantizing = True
        if not quantizing:
            q[name] = {k: dict(v) for k, v in params[name].items()}
            s_prev = _act_scale(scales, name)
            boundary = {"in_scale": np.float32(s_prev)}
            continue
        s_sq = _act_scale(scales, name + "/squeeze1x1")
        s_out = _act_scale(scales, name)
        q[name] = {
            "squeeze1x1": dict(
                _quantize_conv(params[name]["squeeze1x1"], s_prev, s_sq),
                **boundary),
            "expand1x1": _quantize_conv(params[name]["expand1x1"],
                                        s_sq, s_out),
            "expand3x3": _quantize_conv(params[name]["expand3x3"],
                                        s_sq, s_out),
        }
        boundary = {}
        s_prev = s_out
    if not quantizing:
        raise ValueError("start layer {!r} not in the chain".format(start))
    q[head] = _quantize_conv(params[head], s_prev, None)
    return q


def _quantize_conv_chain(mod, params, scales: Scales, s_input: float,
                         head: str, start: str) -> dict:
    """vgg16: conv1_1..conv5_3 -> head (dropout is the identity at
    inference, so the head takes conv5_3's scale)."""
    q = {}
    quantizing = False
    s_prev = s_input
    boundary = {}
    for name, _, _ in mod._CONVS:
        if name == start:
            quantizing = True
            # from the first conv on, the input arrives int8
            # (quantize_images): no float boundary to re-quantize
            boundary = {} if name == mod._CONVS[0][0] else \
                {"in_scale": np.float32(s_prev)}
        if not quantizing:
            q[name] = dict(params[name])
            s_prev = _act_scale(scales, name)
            continue
        s_out = _act_scale(scales, name)
        q[name] = dict(_quantize_conv(params[name], s_prev, s_out),
                       **boundary)
        boundary = {}
        s_prev = s_out
    if not quantizing:
        raise ValueError("start layer {!r} not in the chain".format(start))
    q[head] = _quantize_conv(params[head], s_prev, None)
    return q


def _fold_bn(layer: dict, eps: float) -> dict:
    """Fold frozen-statistics batch norm into the conv: ``W' = W*inv[o]``
    and ``b' = bias*inv + beta - mean*inv`` with ``inv =
    gamma/sqrt(var+eps)``, in float64, rounded to f32 once."""
    inv = np.asarray(layer["gamma"], np.float64) / np.sqrt(
        np.asarray(layer["var"], np.float64) + eps)
    w = np.asarray(layer["kernel"], np.float64) * inv
    b = np.asarray(layer["beta"], np.float64) - \
        np.asarray(layer["mean"], np.float64) * inv
    if "bias" in layer:
        b = b + np.asarray(layer["bias"], np.float64) * inv
    return {"kernel": np.asarray(w, np.float32),
            "bias": np.asarray(b, np.float32)}


def _quantize_resnet(mod, params, scales: Scales, start: str,
                     eps: float) -> dict:
    """resnet50: conv1 stays float; quantization starts at block
    ``start``.  In an int8 block, branch2a/b re-quantize to int8,
    branch2c and the projection shortcut dequantize to f32, the join
    runs in f32 and the block output re-quantizes at ``out_scale``."""
    q = {"conv1": dict(params["conv1"]), "conv5": None}
    quantizing = False
    s_prev = _act_scale(scales, "conv1")
    boundary = {}
    for stage, blocks, _, _, _ in mod._STAGES:
        for block in blocks:
            name = "res{}{}".format(stage, block)
            if name == start:
                quantizing = True
                boundary = {"in_scale": np.float32(s_prev)}
            if not quantizing:
                q[name] = {k: (dict(v) if k == "branch1" else
                               {s: dict(c) for s, c in v.items()})
                           for k, v in params[name].items()}
                s_prev = _act_scale(scales, name)
                continue
            p = params[name]
            entry = {}
            if "branch1" in p:
                entry["branch1"] = dict(
                    _quantize_conv(_fold_bn(p["branch1"], eps),
                                   s_prev, None), **boundary)
            elif not boundary:
                # an int8 identity shortcut is dequantized at its
                # producer's scale before the f32 join
                entry["shortcut_scale"] = np.float32(s_prev)
            s_2a = _act_scale(scales, name + "_branch2a")
            s_2b = _act_scale(scales, name + "_branch2b")
            entry["branch2"] = {
                "branch2a": dict(
                    _quantize_conv(_fold_bn(p["branch2"]["branch2a"],
                                            eps), s_prev, s_2a),
                    **boundary),
                "branch2b": _quantize_conv(
                    _fold_bn(p["branch2"]["branch2b"], eps), s_2a, s_2b),
                "branch2c": _quantize_conv(
                    _fold_bn(p["branch2"]["branch2c"], eps), s_2b, None),
            }
            s_prev = _act_scale(scales, name)
            entry["out_scale"] = np.float32(s_prev)
            q[name] = entry
            boundary = {}
    if not quantizing:
        raise ValueError("start layer {!r} not in the chain".format(start))
    q["conv5"] = _quantize_conv(params["conv5"], s_prev, None)
    return q


#: default quantization boundary per net, the JAX package's: whole-net
#: int8 where the net allows it; ResNet50's conv1 (a conv + batch norm
#: over the raw image) always stays float, its blocks quantize from res2a
DEFAULT_START = {"squeezeDet": "conv1", "squeezeDet+": "conv1",
                 "vgg16": "conv1_1", "resnet50": "res2a"}


def quantized_tree(det, scales: Scales, start: str = "") -> dict:
    """The float ``det``'s weights and calibration scales -> the JAX
    package's int8 tree (numpy leaves, HWIO kernels), with
    :data:`INPUT_SCALE_KEY` in whole-net mode."""
    from squeezedet_torch.models import resnet50, squeezedet, \
        squeezedet_plus, vgg16
    from squeezedet_torch.weights import to_jax_params
    start = start or DEFAULT_START[det.net]
    params = to_jax_params(det.backbone.state_dict())
    s_input = input_scale(det.cfg.bgr_means)
    if det.net == "squeezeDet":
        q = _quantize_fire_chain(squeezedet, params, scales, s_input,
                                 head="conv12", start=start)
    elif det.net == "squeezeDet+":
        q = _quantize_fire_chain(squeezedet_plus, params, scales, s_input,
                                 head="conv12", start=start)
    elif det.net == "vgg16":
        q = _quantize_conv_chain(vgg16, params, scales, s_input,
                                 head="conv6", start=start)
    elif det.net == "resnet50":
        q = _quantize_resnet(resnet50, params, scales, start=start,
                             eps=det.cfg.batch_norm_epsilon)
    else:
        raise ValueError("unknown backbone for quantization: {}".format(
            det.net))
    if start in ("conv1", "conv1_1"):
        q[INPUT_SCALE_KEY] = np.float32(s_input)
    return q


def quantize_detector(det, scales: Scales, start: str = ""):
    """Float detector + calibration scales -> a new int8 ``Detector`` on
    the same device (``det`` is untouched).  ``start`` names the first
    quantized layer (default :data:`DEFAULT_START`); layers before it
    stay float.  With ``start='conv1'``/``'conv1_1'`` the whole net is
    int8 and the images themselves are quantized
    (``Detector.input_scale``)."""
    from squeezedet_torch.weights import from_jax_qparams
    return from_jax_qparams(det, quantized_tree(det, scales, start))


def quantize(det, batches_u8: Iterable, start: str = "",
             percentile: Optional[float] = None):
    """One-call PTQ: calibrate on ``batches_u8``, then quantize."""
    return quantize_detector(det, calibrate(det, batches_u8,
                                            percentile=percentile),
                             start=start)


def calib_batch_from_images(path: str, width: int, height: int,
                            limit: int = 8) -> np.ndarray:
    """Calibration frames for the export, serve, demo and report CLIs:
    ``path`` is an image file, a directory of images or a glob pattern;
    returns one uint8 BGR batch of up to ``limit`` frames at the model
    resolution.  Frames decode with the data layer's ``read_frame`` and
    resize with OpenCV where it imports, else with the bilinear device
    resize of the eval reader (``augment_resize_normalize``, on the CPU),
    rounded back to uint8."""
    import glob
    import os

    from squeezedet_torch.data.imdb import _opencv, read_frame

    if os.path.isdir(path):
        files = sorted(
            f for f in glob.glob(os.path.join(path, "*"))
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    elif not os.path.isfile(path):
        files = sorted(glob.glob(path))
    else:
        files = [path]
    cv2 = _opencv()
    frames = []
    for f in files[:limit]:
        try:
            im = read_frame(f)
        except ValueError:
            continue
        if cv2 is not None:
            frames.append(cv2.resize(im, (width, height)))
        else:
            frames.append(_resize_u8(im, width, height))
    if not frames:
        raise ValueError("no readable calibration images under {}".format(
            path))
    return np.stack(frames).astype(np.uint8)


def _resize_u8(im: np.ndarray, width: int, height: int) -> np.ndarray:
    """One uint8 frame resized bilinearly by the device pipeline's
    resize, on the CPU, rounded to uint8."""
    from squeezedet_torch.data.device_pipeline import \
        augment_resize_normalize
    h0, w0 = im.shape[:2]
    aug = torch.tensor([[0.0, 0.0, 0.0, float(w0), float(h0)]])
    out = augment_resize_normalize(torch.from_numpy(im[None]), aug, height,
                                   width, (0.0, 0.0, 0.0))
    return torch.clamp(torch.round(out[0]), 0, 255).to(torch.uint8).numpy()
