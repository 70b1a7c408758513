"""The exported inference artifact and the data-parallel serving
program (counterpart of ``squeezedet_tpu/serving.py``).

:func:`export_model` traces the whole inference program of a detector,
weights included, with ``torch.export`` on the detector's device and
writes a directory: ``model.pt2`` (``torch.export.save``) and
``metadata.json`` with the JAX package's keys (class names, input
geometry, the output contract), ``platforms`` naming the device it was
traced on.  :func:`load_exported` runs it without the model code.  A
float squeezeDet artifact calls K1 as the registered op
``squeezedet_torch::conv1_pool1`` (``ops/fused_frontend.py``), so the
artifact launches the kernel on the card; an int8 artifact holds the int8
program (``quant.py``) of a quantized detector.

The JAX package's layout-negotiated entry (``negotiated_inference_fn``)
is an XLA mechanism and stays out of the port (ROADMAP Queue 1 item 14).
:func:`mesh_inference_fn` serves a micro-batch over several replicas.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from squeezedet_torch.data.device_pipeline import normalize_images

def mesh_inference_fn(det, batch_size: int, mesh):
    """The uint8 -> detections program over ``mesh`` (devices,
    ``parallel.mesh.make_mesh``): one replica of ``det`` per device, each
    running the whole program (int8 for a quantized ``det``) on its
    ``batch_size / D`` rows on its own device and stream.  Inference has
    no term across images, so the replicas share nothing.

    Returns ``run``: a uint8 [batch_size, H, W, 3] numpy batch -> numpy
    (boxes, probs, classes, keep) of the whole batch.
    """
    from squeezedet_torch.parallel.mesh import (replicate, run_replicas,
                                                shard_slices)
    slices = shard_slices(batch_size, len(mesh))
    replicas = replicate(det, mesh)

    def program(d, images_u8):
        if d.quantized:
            return d.predict_quant_postprocessed(images_u8)
        return d.predict_raw_postprocessed(images_u8)

    def run(images_u8):
        x = np.ascontiguousarray(images_u8)
        outs = run_replicas(program, replicas, [
            (torch.from_numpy(x[sl]).to(d.anchors.device),)
            for sl, d in zip(slices, replicas)])
        return tuple(np.concatenate([o[i].numpy() for o in outs])
                     for i in range(len(outs[0])))

    return run


PROGRAM_FILE = "model.pt2"
METADATA_FILE = "metadata.json"


class InferenceProgram(nn.Module):
    """The program an artifact holds: images [B, H, W, 3] (uint8 BGR, or
    mean-subtracted f32) -> the on-device top-K + NMS detections (boxes,
    probs, classes, keep) or, without ``postprocess``, the raw (det_boxes,
    det_probs, det_class).  A plain module (the Detector's predict
    methods run under inference mode, which ``torch.export`` does not
    trace); int8 when ``det`` is quantized."""

    def __init__(self, det, uint8_input: bool = True,
                 postprocess: bool = True):
        super().__init__()
        self.det = det
        self.uint8_input = uint8_input
        self.postprocess = postprocess

    def forward(self, images: torch.Tensor):
        det = self.det
        if det.quantized:
            x = det.quant_input(images) if self.uint8_input else \
                det.quant_input_normalized(images)
        elif self.uint8_input:
            x = normalize_images(images, det.cfg.bgr_means,
                                 det.compute_dtype)
        else:
            x = images.to(det.compute_dtype).contiguous()
        interp = det.interpret(det.backbone(x).float())
        if not self.postprocess:
            return interp.det_boxes, interp.det_probs, interp.det_class
        return det.postprocess_device(interp)


def export_model(det, path: str, *, batch_size: int = 1,
                 uint8_input: bool = True, postprocess: bool = True) -> None:
    """Trace ``det``'s inference program at ``batch_size`` on its device
    and write the artifact directory ``path`` (``model.pt2`` and
    ``metadata.json``).  A quantized ``det`` (``Detector.quantize``)
    gives the int8 program, with the same input and output contract."""
    cfg = det.cfg
    device = det.anchors.device
    program = InferenceProgram(det, uint8_input, postprocess).eval()
    example = torch.zeros(
        (batch_size, cfg.image_height, cfg.image_width, 3),
        dtype=torch.uint8 if uint8_input else torch.float32, device=device)
    with torch.no_grad():
        exported = torch.export.export(program, (example,))
    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, PROGRAM_FILE))
    meta = {
        "net": det.net,
        "class_names": list(cfg.class_names),
        "image_height": cfg.image_height,
        "image_width": cfg.image_width,
        "batch_size": batch_size,
        "input_dtype": "uint8" if uint8_input else "float32",
        "input_is_bgr_raw": bool(uint8_input),
        "quantized": bool(det.quantized),
        "bgr_means": [float(m) for m in cfg.bgr_means],
        "postprocess": bool(postprocess),
        "outputs": ("boxes[B,K,4] cx,cy,w,h; probs[B,K]; classes[B,K]; "
                    "keep[B,K]" if postprocess else
                    "det_boxes[B,A,4]; det_probs[B,A]; det_class[B,A]"),
        "plot_prob_thresh": float(cfg.plot_prob_thresh),
        "platforms": [device.type],
    }
    with open(os.path.join(path, METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=2)


def load_exported(path: str, device=None):
    """Load an :func:`export_model` artifact.

    Returns ``(fn, metadata)``: ``fn(images)`` takes a numpy array or a
    tensor of the exported shape and dtype, runs the program on the
    device it was traced on, and returns its outputs as tensors there.
    ``device`` (default: that device) must be of the traced kind: the
    program's weights and constants live there, so another device is
    refused, as is a CUDA artifact where torch has no CUDA device.
    """
    # the program calls K1 as squeezedet_torch::conv1_pool1, which this
    # import registers
    import squeezedet_torch.ops.fused_frontend  # noqa: F401

    with open(os.path.join(path, METADATA_FILE)) as f:
        meta = json.load(f)
    traced = meta["platforms"][0]
    target = torch.device(device if device is not None else traced)
    if target.type != traced:
        raise ValueError(
            "artifact {} was traced on {} and runs there only, not on {}: "
            "export it again with --device {}".format(
                path, traced, target, target.type))
    if traced == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("artifact {} was traced on cuda, and torch has no "
                           "CUDA device here".format(path))
    module = torch.export.load(os.path.join(path, PROGRAM_FILE)).module()

    def fn(images):
        x = torch.as_tensor(images).to(target)
        with torch.inference_mode():
            return tuple(module(x))

    return fn, meta
