"""The spatially partitioned forward (counterpart of
``squeezedet_tpu/parallel/spatial.py``).

The backbone runs over height x width tiles with hand-written halo
exchanges (``models/halo.py``) and the feature map is gathered only at
the detection head, on the detector's device, where the interpretation
and the postprocess run.  Uses: batch-1 inference spread over several
devices instead of one (the reference's eval protocol, ``eval.py``),
frames whose activations would not fit one device, and training past
one image per device on the data axis (``trainer.py``, ``spatial=``).
Every float squeezeDet tile launches K1 once.
"""

from __future__ import annotations

from typing import Callable

import torch

from squeezedet_torch.parallel.mesh import shard_slices


def spatial_predict_fn(det, mesh, postprocess: bool = True,
                       uint8_input: bool = False) -> Callable:
    """The forward over ``mesh`` (a ``parallel.mesh.SpatialMesh``): the
    batch's rows split over its data coordinates, each coordinate's
    images over its tiles.

    Returns ``fn(images)`` for images on ``det``'s device (uint8 BGR
    with ``uint8_input``, else mean-subtracted), whose outputs are the
    whole batch's on that device: with ``postprocess`` the on-device
    top-K + NMS (boxes, probs, classes, keep), otherwise the raw
    interpretation ``(det_boxes, det_probs, det_class)``.  An int8
    detector runs its int8 program.
    """
    def forward(images, tiling):
        if det.quantized:
            interp = det.predict_quant(images, tiling) if uint8_input \
                else det.predict_quant_normalized(images, tiling)
        elif uint8_input:
            interp = det.predict_raw(images, tiling)
        else:
            interp = det.predict(images, tiling)
        if postprocess:
            return det.postprocess_device(interp)
        return interp.det_boxes, interp.det_probs, interp.det_class

    def fn(images):
        slices = shard_slices(images.shape[0], mesh.n_data)
        outs = [forward(images[sl], mesh.tiling(d))
                for d, sl in enumerate(slices)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    return fn
