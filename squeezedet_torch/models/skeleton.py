"""Detection interpretation graph (counterpart of
``squeezedet_tpu/models/skeleton.py``; the loss arrives with the train
step).

Channel-layout contract: the ConvDet output [B, H, W, APG*(C+1+4)] is
sliced as [class_probs | conf | deltas] with anchor-major, class-minor
grouping.  ``preds`` must be NHWC before those reshapes; an NCHW head
output is permuted first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from squeezedet_torch.ops.boxes import safe_exp


class Interpretation(NamedTuple):
    """Decoded network output (all per-anchor, fixed shapes)."""

    pred_class_probs: torch.Tensor  # [B, A, C] softmax class probabilities
    pred_conf: torch.Tensor         # [B, A] sigmoid confidence
    pred_box_delta: torch.Tensor    # [B, A, 4] raw deltas
    det_boxes: torch.Tensor         # [B, A, 4] decoded (cx, cy, w, h), clipped
    det_probs: torch.Tensor         # [B, A] max_c class_prob*conf
    det_class: torch.Tensor         # [B, A] argmax class index (int32)
    pred_class_logits: Optional[torch.Tensor] = None  # [B, A, C] pre-softmax


def interpret(preds: torch.Tensor, anchors: torch.Tensor, *,
              num_classes: int, anchor_per_grid: int, image_width: int,
              image_height: int, exp_thresh: float = 1.0) -> Interpretation:
    """Interpretation graph: preds [B, H, W, APG*(C+1+4)] NHWC and
    anchors [A, 4] (cx, cy, w, h) -> :class:`Interpretation`."""
    b = preds.shape[0]
    num_anchors = anchors.shape[0]
    c = num_classes
    num_class_probs = anchor_per_grid * c
    num_conf = num_class_probs + anchor_per_grid

    pred_class_logits = preds[..., :num_class_probs].reshape(
        b, num_anchors, c)
    pred_class_probs = torch.softmax(pred_class_logits, dim=-1)
    pred_conf = torch.sigmoid(
        preds[..., num_class_probs:num_conf].reshape(b, num_anchors))
    pred_box_delta = preds[..., num_conf:].reshape(b, num_anchors, 4)

    anchors = anchors.to(pred_box_delta.dtype)
    ax, ay, aw, ah = anchors[:, 0], anchors[:, 1], anchors[:, 2], anchors[:, 3]
    dx, dy, dw, dh = pred_box_delta.unbind(-1)
    box_cx = ax + dx * aw
    box_cy = ay + dy * ah
    box_w = aw * safe_exp(dw, exp_thresh)
    box_h = ah * safe_exp(dh, exp_thresh)

    # corner clip to [0, W-1] x [0, H-1] in the reference's op order, then
    # back to centers with the +1 pixel w/h convention
    xmins = (box_cx - box_w / 2).clamp(min=0.0).clamp(max=image_width - 1.0)
    ymins = (box_cy - box_h / 2).clamp(min=0.0).clamp(max=image_height - 1.0)
    xmaxs = (box_cx + box_w / 2).clamp(max=image_width - 1.0).clamp(min=0.0)
    ymaxs = (box_cy + box_h / 2).clamp(max=image_height - 1.0).clamp(min=0.0)
    width = xmaxs - xmins + 1.0
    height = ymaxs - ymins + 1.0
    det_boxes = torch.stack(
        [xmins + 0.5 * width, ymins + 0.5 * height, width, height], dim=-1)

    # final score = class_prob * conf; top class (first index on ties)
    probs = pred_class_probs * pred_conf[..., None]
    det_probs, det_class = torch.max(probs, dim=2)
    det_class = det_class.to(torch.int32)

    return Interpretation(pred_class_probs, pred_conf, pred_box_delta,
                          det_boxes, det_probs, det_class,
                          pred_class_logits)
