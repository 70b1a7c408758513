"""Model registry + Detector facade (counterpart of
``squeezedet_tpu/models/__init__.py``).

:class:`Detector` bundles a backbone with the shared interpretation
graph and postprocessing, so entry points deal with one object.  Unlike
the JAX facade it owns its parameters, as an ``nn.Module``; the weight
bridge (``squeezedet_torch.weights``) loads the JAX package's.  Its int8
twin is another ``Detector`` (:meth:`Detector.quantize`), whose
``predict_quant*`` methods serve it.

Every forward method takes ``spatial``, a ``models.halo.Tiling``: the
images (on the detector's device) are cut into its height x width tiles
on the boundaries of the net's output grid, the backbone runs over the
tiles with halo exchanges (``models/halo.py``), and the head's output
is gathered on the detector's device, where the interpretation, the loss
and the postprocess run as they do unsharded.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from squeezedet_torch.config import ModelConfig, config_for_net
from squeezedet_torch.data.device_pipeline import (normalize_images,
                                                   resize_images)
from squeezedet_torch.models import layers as L
from squeezedet_torch.models import (resnet50, squeezedet, squeezedet_plus,
                                     vgg16)
from squeezedet_torch.models.skeleton import (Interpretation, LossBreakdown,
                                              Targets, detection_loss,
                                              interpret)
from squeezedet_torch.ops.postprocess import filter_prediction_device
from squeezedet_torch.utils.profiling import span

_BACKBONES = {
    "squeezeDet": squeezedet.SqueezeDet,
    "squeezeDet+": squeezedet_plus.SqueezeDetPlus,
    "vgg16": vgg16.VGG16,
    "resnet50": resnet50.ResNet50,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def available_nets():
    """The backbone names :func:`get_model` takes."""
    return tuple(_BACKBONES)


class Detector(nn.Module):
    """A backbone + the shared ConvDet skeleton.

    Typical use::

        det = get_model('squeezeDet', cfg, device='cuda')
        boxes, probs, classes, keep = det.predict_raw_postprocessed(u8)
    """

    def __init__(self, cfg: ModelConfig, backbone: nn.Module, net: str, *,
                 device):
        super().__init__()
        self.cfg = cfg
        self.net = net
        self.backbone = backbone
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.register_buffer(
            "anchors", torch.tensor(cfg.anchor_box, dtype=torch.float32,
                                    device=device), persistent=False)

    # -- parameters ---------------------------------------------------------
    @property
    def tracer(self) -> L.NetTracer:
        """The backbone's shape and accounting walk (``model_metrics.txt``)."""
        return self.backbone.tracer

    def layers(self):
        """The backbone's conv layers (:class:`layers.Conv` and
        :class:`layers.ConvBN`), in construction order."""
        return [m for m in self.backbone.modules()
                if isinstance(m, (L.Conv, L.ConvBN))]

    @torch.no_grad()
    def load_pretrained(self, weights) -> None:
        """Copy caffe-pickle entries onto the backbone's layers, found by
        each layer's caffe name: ``{name: [kernel OIHW, bias]}`` for a
        conv (bias only where the layer has one), plus ``{bn_name: [mean,
        var], scale_name: [gamma, beta]}`` for a conv + batch norm.
        Layers without an entry, or with one of another shape, keep their
        random init and are printed; entries that matched no layer are
        listed."""
        from squeezedet_torch.checkpoint.importer import (TrackedWeights,
                                                          warn_unconsumed)
        weights = TrackedWeights(weights)
        for layer in self.layers():
            names = [layer.name]
            if isinstance(layer, L.ConvBN):
                names += [layer.bn_name, layer.scale_name]
            missing = [n for n in names if n not in weights]
            if missing:
                print("Cannot find {} in the pretrained model, use randomly "
                      "initialized parameter".format(", ".join(missing)))
                continue
            blobs = weights[layer.name]
            pairs = [(layer.weight, blobs[0])]
            if layer.bias is not None:
                pairs.append((layer.bias, blobs[1] if len(blobs) > 1
                              else None))
            if isinstance(layer, L.ConvBN):
                pairs += list(zip((layer.mean, layer.var),
                                  weights[layer.bn_name][:2]))
                pairs += list(zip((layer.gamma, layer.beta),
                                  weights[layer.scale_name][:2]))
            if any(b is None or np.shape(b) != tuple(t.shape)
                   for t, b in pairs):
                print("Shape of the pretrained parameter of {} does not "
                      "match, use randomly initialized parameter".format(
                          layer.name))
                continue
            for t, b in pairs:
                t.copy_(torch.from_numpy(np.asarray(b, np.float32)))
        warn_unconsumed(weights)

    def trainable_mask(self) -> Dict[str, bool]:
        """Backbone state_dict name -> whether it trains: a parameter
        trains unless its layer is frozen (``requires_grad=False``); the
        batch-norm statistics (buffers) never train."""
        mask = {name: p.requires_grad
                for name, p in self.backbone.named_parameters()}
        mask.update((name, False) for name in self.backbone.state_dict()
                    if name not in mask)
        return mask

    # -- forward ------------------------------------------------------------
    def run_backbone(self, images: torch.Tensor, *, spatial=None,
                     **kwargs) -> torch.Tensor:
        """The backbone (``kwargs``: ``train``, ``generator``, ``tape``) on
        ``images``, or over ``spatial``'s tiles of them, gathered at the
        head on the images' device."""
        if spatial is None:
            return self.backbone(images, **kwargs)
        tiles = spatial.split(images, self.tracer.height, self.tracer.width)
        return self.backbone(tiles, **kwargs).gather()

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                spatial=None) -> torch.Tensor:
        """Backbone + ConvDet head -> raw preds [B, H, W, APG*(C+5)] f32.
        ``train`` turns dropout on, drawn from ``generator`` (on the
        images' device)."""
        images = images.to(self.compute_dtype).contiguous()
        return self.run_backbone(images, spatial=spatial, train=train,
                                 generator=generator).float()

    def interpret(self, preds: torch.Tensor) -> Interpretation:
        cfg = self.cfg
        return interpret(
            preds, self.anchors, num_classes=cfg.classes,
            anchor_per_grid=cfg.anchor_per_grid,
            image_width=cfg.image_width, image_height=cfg.image_height,
            exp_thresh=cfg.exp_thresh)

    @torch.inference_mode()
    def predict(self, images: torch.Tensor, spatial=None) -> Interpretation:
        """Inference graph on mean-subtracted images: forward + interpret."""
        return self.interpret(self(images, spatial=spatial))

    @torch.inference_mode()
    def predict_raw(self, images_u8: torch.Tensor,
                    spatial=None) -> Interpretation:
        """Serving path: uint8 BGR images [B, H, W, 3] -> Interpretation,
        with the mean subtraction on the device: the spans ``ingest``,
        ``backbone`` and ``interpret`` (``utils/profiling.span``)."""
        dev = images_u8.device
        with span("ingest", dev):
            images = normalize_images(images_u8, self.cfg.bgr_means,
                                      self.compute_dtype)
        with span("backbone", dev):
            preds = self.run_backbone(images, spatial=spatial).float()
        with span("interpret", dev):
            return self.interpret(preds)

    @torch.inference_mode()
    def predict_raw_resize(self, images_u8: torch.Tensor) -> Interpretation:
        """Serving path for native-resolution frames: uint8 BGR at any
        fixed [B, H0, W0, 3] -> bilinear resize to the model resolution
        (``resize_images``, f32) -> mean subtraction in the compute dtype
        -> Interpretation, all on the images' device.  The caller scales
        the boxes back by the frame's size over the model's."""
        cfg = self.cfg
        resized = resize_images(images_u8, cfg.image_height, cfg.image_width)
        images = normalize_images(resized, cfg.bgr_means, self.compute_dtype)
        return self.interpret(self.run_backbone(images).float())

    @torch.inference_mode()
    def activation_stats(self, images: torch.Tensor, sample: int = 65536
                         ) -> Dict[str, Dict[str, np.ndarray]]:
        """Five-stat activation summary data per layer of one eval-mode
        forward of mean-subtracted ``images``: ``{layer: {'sample',
        'sparsity', 'mean', 'max', 'min'}}`` as numpy, the layers being
        the backbone's activation tape (squeezeDet's conv1 before pool1,
        so that forward runs conv1 and pool1 as two ops, not K1) and the
        decoded box coordinates ``det_boxes/{cx,cy,w,h}``.  The stats are
        reduced on the device; ``sample`` is the flattened activation at
        stride ``max(1, n // sample)``, so at most 2x ``sample`` elements
        cross to the host at any batch size."""
        tape: dict = {}
        preds = self.backbone(images.to(self.compute_dtype).contiguous(),
                              tape=tape)
        interp = self.interpret(preds.float())
        for i, coord in enumerate(("cx", "cy", "w", "h")):
            tape["det_boxes/" + coord] = interp.det_boxes[..., i]
        out = {}
        for name, act in tape.items():
            flat = act.reshape(-1).float()
            stride = max(1, flat.shape[0] // sample)
            out[name] = {"sample": flat[::stride],
                         "sparsity": torch.mean((flat == 0.0).float()),
                         "mean": torch.mean(flat), "max": torch.max(flat),
                         "min": torch.min(flat)}
        return {name: {k: v.cpu().numpy() for k, v in stats.items()}
                for name, stats in out.items()}

    # -- int8 serving (quant.py) ---------------------------------------------
    @property
    def quantized(self) -> bool:
        """Whether this is an int8 detector (:meth:`quantize`)."""
        return any(isinstance(m, L.QConv) for m in self.backbone.modules())

    def quantize(self, calib_batches_u8, start: str = "",
                 percentile: Optional[float] = None) -> "Detector":
        """Post-training int8 quantization: calibrate activation ranges on
        uint8 batches and return a new int8 detector (``quant.py``);
        this one is left as it was.  ``start`` names the first quantized
        layer (default: the JAX package's boundary for the net);
        ``percentile`` calibrates at that percentile of |activation|
        instead of the abs-max."""
        from squeezedet_torch.quant import quantize
        return quantize(self, calib_batches_u8, start=start,
                        percentile=percentile)

    def quant_input(self, images_u8: torch.Tensor) -> torch.Tensor:
        """The int8 backbone's input from uint8 BGR images: int8 at
        ``input_scale`` in whole-net mode (the scale stored at quantize
        time, never re-derived from the config), else mean-subtracted in
        the compute dtype for the float layers before the boundary."""
        from squeezedet_torch.quant import quantize_images
        scale = getattr(self, "input_scale", None)
        if scale is not None:
            return quantize_images(images_u8, self.cfg.bgr_means, scale)
        return normalize_images(images_u8, self.cfg.bgr_means,
                                self.compute_dtype)

    def quant_input_normalized(self, images: torch.Tensor) -> torch.Tensor:
        """:meth:`quant_input` for mean-subtracted float images."""
        from squeezedet_torch.quant import quantize_images_normalized
        scale = getattr(self, "input_scale", None)
        if scale is not None:
            return quantize_images_normalized(images, scale)
        return images.to(self.compute_dtype).contiguous()

    @torch.inference_mode()
    def predict_quant(self, images_u8: torch.Tensor,
                      spatial=None) -> Interpretation:
        """int8 serving path: uint8 BGR images -> Interpretation, the
        backbone's convs as int8 GEMMs with int32 accumulation."""
        return self.interpret(self.run_backbone(
            self.quant_input(images_u8), spatial=spatial).float())

    @torch.inference_mode()
    def predict_quant_postprocessed(self, images_u8: torch.Tensor,
                                    spatial=None):
        """int8 twin of :meth:`predict_raw_postprocessed`."""
        return self.postprocess_device(self.predict_quant(images_u8,
                                                          spatial))

    @torch.inference_mode()
    def predict_quant_normalized(self, images: torch.Tensor,
                                 spatial=None) -> Interpretation:
        """int8 twin of :meth:`predict` for mean-subtracted float images
        (the eval and demo readers' format)."""
        return self.interpret(self.run_backbone(
            self.quant_input_normalized(images), spatial=spatial).float())

    # -- loss ---------------------------------------------------------------
    def loss(self, images: torch.Tensor, targets: Targets,
             generator: Optional[torch.Generator] = None,
             train: bool = True, *, num_objects=None, batch_size=None,
             weight_decay: bool = True, spatial=None) -> LossBreakdown:
        """Forward (with dropout when training) + interpretation + the
        3-term loss plus weight decay on the trainable conv weights.

        A data-parallel rank passes the global ``num_objects`` and
        ``batch_size`` (``detection_loss``), ``generator`` as
        ``layers.BatchRows`` (the global batch's dropout draws), and
        ``weight_decay`` on one rank only, so that the decay enters the
        summed gradient once."""
        cfg = self.cfg
        interp = self.interpret(self(images, train=train,
                                     generator=generator, spatial=spatial))
        wd = L.weight_decay_loss(self.backbone, cfg.weight_decay) \
            if weight_decay else 0.0
        return detection_loss(
            interp, targets, num_anchors=cfg.anchors,
            loss_coef_class=cfg.loss_coef_class,
            loss_coef_conf_pos=cfg.loss_coef_conf_pos,
            loss_coef_conf_neg=cfg.loss_coef_conf_neg,
            loss_coef_bbox=cfg.loss_coef_bbox,
            epsilon=cfg.epsilon, weight_decay_term=wd,
            num_objects=num_objects, batch_size=batch_size)

    # -- postprocess ---------------------------------------------------------
    def filter_prediction(self, boxes, probs, cls_idx):
        """Host top-N + per-class NMS of one image's numpy predictions."""
        from squeezedet_torch.ops.nms import filter_prediction_np
        cfg = self.cfg
        return filter_prediction_np(
            np.asarray(boxes), np.asarray(probs), np.asarray(cls_idx),
            classes=cfg.classes, top_n_detection=cfg.top_n_detection,
            prob_thresh=cfg.prob_thresh, nms_thresh=cfg.nms_thresh)

    def postprocess_device(self, interp: Interpretation):
        """On-device top-K + per-class NMS with this model's thresholds
        (the span ``postprocess``)."""
        cfg = self.cfg
        with span("postprocess", interp.det_boxes.device):
            return filter_prediction_device(
                interp.det_boxes, interp.det_probs, interp.det_class,
                top_n=cfg.top_n_detection, nms_thresh=cfg.nms_thresh,
                num_classes=cfg.classes, prob_thresh=cfg.prob_thresh)

    @torch.inference_mode()
    def predict_postprocessed(self, images: torch.Tensor, spatial=None):
        """Forward + decode + top-K + NMS on mean-subtracted images:
        fixed-shape (boxes [B,K,4], probs [B,K], classes [B,K],
        keep [B,K])."""
        return self.postprocess_device(self.predict(images, spatial))

    @torch.inference_mode()
    def predict_raw_postprocessed(self, images_u8: torch.Tensor,
                                  spatial=None):
        """uint8 twin of :meth:`predict_postprocessed`: the whole
        uint8 -> detections program."""
        return self.postprocess_device(self.predict_raw(images_u8, spatial))


def get_model(net: str, cfg: Optional[ModelConfig] = None, *, device,
              generator: Optional[torch.Generator] = None) -> Detector:
    """Build a randomly initialised Detector by reference net name on
    ``device``.  ``generator`` (a CPU generator; seed 0 when omitted)
    draws the initial weights."""
    if net not in _BACKBONES:
        raise ValueError(
            "Selected neural net architecture not supported: {}".format(net))
    if cfg is None:
        cfg = config_for_net(net)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    backbone = _BACKBONES[net](cfg, device=device, generator=generator)
    return Detector(cfg, backbone, net, device=device).eval()
