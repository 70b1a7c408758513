"""Detection interpretation graph and loss (counterpart of
``squeezedet_tpu/models/skeleton.py``).

Channel-layout contract: the ConvDet output [B, H, W, APG*(C+1+4)] is
sliced as [class_probs | conf | deltas] with anchor-major, class-minor
grouping.  ``preds`` must be NHWC before those reshapes; an NCHW head
output is permuted first.
"""

from __future__ import annotations

import math
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


def tensor_iou(box1, box2, mask: torch.Tensor,
               epsilon: float) -> torch.Tensor:
    """IoU of corner-format box tuples (xmin, ymin, xmax, ymax), each
    element [B, A], times ``mask``."""
    xmin = torch.maximum(box1[0], box2[0])
    ymin = torch.maximum(box1[1], box2[1])
    xmax = torch.minimum(box1[2], box2[2])
    ymax = torch.minimum(box1[3], box2[3])
    w = (xmax - xmin).clamp(min=0.0)
    h = (ymax - ymin).clamp(min=0.0)
    intersection = w * h
    w1 = box1[2] - box1[0]
    h1 = box1[3] - box1[1]
    w2 = box2[2] - box2[0]
    h2 = box2[3] - box2[1]
    union = w1 * h1 + w2 * h2 - intersection
    return intersection / (union + epsilon) * mask


def _center_to_corners(boxes: torch.Tensor):
    cx, cy, w, h = boxes.unbind(-1)
    return (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)


class Targets(NamedTuple):
    """Dense training targets, one row per anchor."""

    input_mask: torch.Tensor       # [B, A] 1.0 where an anchor owns a gt box
    box_delta_input: torch.Tensor  # [B, A, 4] target deltas
    box_input: torch.Tensor        # [B, A, 4] gt boxes (cx, cy, w, h)
    labels: torch.Tensor           # [B, A, C] one-hot class labels


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    class_loss: torch.Tensor
    conf_loss: torch.Tensor
    bbox_loss: torch.Tensor
    mean_iou: torch.Tensor


def detection_loss(interp: Interpretation, targets: Targets, *,
                   num_anchors: int, loss_coef_class: float,
                   loss_coef_conf_pos: float, loss_coef_conf_neg: float,
                   loss_coef_bbox: float, epsilon: float = 1e-16,
                   weight_decay_term=0.0, num_objects=None,
                   batch_size=None) -> LossBreakdown:
    """The 3-term squeezeDet loss (class, confidence, box) plus the
    weight-decay term, as the JAX function computes it:

    * the class loss is taken in log space from the logits, with the
      row max detached, so saturated softmaxes give bounded gradients
      (the probs-only branch keeps the reference's literal formula);
    * every normaliser is ``max(sum(mask), 1)``, so an all-background
      batch gives zero class and box losses instead of NaN;
    * the confidence target IoU is detached;
    * the negative-anchor denominator is ``max(A - num_objects, 1)``.

    On a data-parallel rank ``targets`` are the rank's rows of the global
    batch: ``num_objects`` is then the global ``sum(mask)`` (all-reduced)
    and ``batch_size`` the global batch, so that each term is this rank's
    part of the global batch's term and the ranks' losses, and their
    gradients, sum to the one-device values.  Omitted, both are this
    batch's own.
    """
    mask = targets.input_mask
    mask3 = mask[..., None]
    if num_objects is None:
        num_objects = mask.sum()
    num_objects = num_objects.clamp(min=1.0)
    if batch_size is None:
        batch_size = mask.shape[0]

    if interp.pred_class_logits is not None:
        logits = interp.pred_class_logits
        m = logits.amax(dim=-1, keepdim=True).detach()
        shifted = logits - m
        e = torch.exp(shifted)
        s = e.sum(dim=-1, keepdim=True)
        # torch.maximum (not clamp) splits the gradient at a tie, as
        # jnp.maximum does: saturated logits reach the floor exactly
        # new_full fills on the device (no host copy: capturable)
        log_floor = logits.new_full((), math.log(epsilon))
        log_p = torch.maximum(shifted - torch.log(s), log_floor)
        # log(1 - p_i) = log(sum_{j != i} e_j) - log(sum_j e_j)
        log_1mp = torch.maximum(
            torch.log(torch.maximum(s - e, logits.new_full((), epsilon)))
            - torch.log(s), log_floor)
        class_loss = torch.sum(
            (targets.labels * (-log_p) + (1 - targets.labels) * (-log_1mp))
            * mask3 * loss_coef_class) / num_objects
    else:
        p = interp.pred_class_probs
        class_loss = torch.sum(
            (targets.labels * (-torch.log(p + epsilon))
             + (1 - targets.labels) * (-torch.log(1 - p + epsilon)))
            * mask3 * loss_coef_class) / num_objects

    ious = tensor_iou(_center_to_corners(interp.det_boxes),
                      _center_to_corners(targets.box_input), mask,
                      epsilon).detach()
    conf_weight = (mask * loss_coef_conf_pos / num_objects
                   + (1 - mask) * loss_coef_conf_neg
                   / (num_anchors - num_objects).clamp(min=1.0))
    conf_loss = torch.sum(torch.sum(
        torch.square(ious - interp.pred_conf) * conf_weight, dim=1)
    ) / batch_size

    bbox_loss = torch.sum(loss_coef_bbox * torch.square(
        mask3 * (interp.pred_box_delta - targets.box_delta_input))
    ) / num_objects

    mean_iou = ious.sum() / num_objects
    total = class_loss + conf_loss + bbox_loss + weight_decay_term
    return LossBreakdown(total, class_loss, conf_loss, bbox_loss, mean_iou)
