"""On-device detection postprocessing: top-K + per-class NMS
(counterpart of ``squeezedet_tpu/ops/postprocess.py``).

The reference walks candidates in descending-score order and suppresses
every later box that overlaps an earlier candidate of its class, so

    keep[j]  <=>  not exists i earlier-in-order, same class:
                  IoU(i, j) > thresh

which is order-free given the ranking: one [K, K] IoU matrix and a
triangular mask, no sequential loop.  Everything is fixed-shape: outputs
are padded to K with a keep mask.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from squeezedet_torch.ops.boxes import pairwise_iou_center


def filter_prediction_device(boxes, probs, cls_idx, *, top_n: int,
                             nms_thresh: float, num_classes: int,
                             prob_thresh: float = 0.0):
    """Batched on-device postprocess.

    Args:
      boxes: [B, A, 4] decoded center-format boxes.
      probs: [B, A] per-anchor max class scores.
      cls_idx: [B, A] integer class indices.
      prob_thresh: applied only when every anchor is a candidate
        (top_n >= A): the host reference switches from top-N selection
        to ``probs > PROB_THRESH`` filtering there.

    Returns:
      (boxes [B, K, 4], probs [B, K], classes [B, K], keep [B, K] bool),
      candidates in descending-probability order.

    Tie-break convention: equal scores rank the LARGER anchor index
    first.  ``torch.topk`` leaves its tie order unspecified, so a stable
    descending sort runs on the index-reversed vector (ties keep the
    smaller reversed index, i.e. the larger original one) and maps back.
    """
    del num_classes  # suppression is same-class-pairwise
    num = probs.shape[1]
    thresh = prob_thresh if top_n >= num else None
    top_n = min(top_n, num)
    top_probs, rev_order = torch.sort(probs.flip(1), dim=1, descending=True,
                                      stable=True)
    top_probs = top_probs[:, :top_n]
    order = num - 1 - rev_order[:, :top_n]
    top_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls_idx, 1, order)

    # eps guards the 0/0 of padded/degenerate zero-area boxes
    iou = pairwise_iou_center(top_boxes, top_boxes, eps=1e-12)
    same_class = top_cls[:, :, None] == top_cls[:, None, :]
    # suppression order: descending prob, ties by LARGER local position
    # first (the host nms's own re-sort); for distinct probs this is the
    # plain triangular i < j mask
    pi, pj = top_probs[:, :, None], top_probs[:, None, :]
    li = torch.arange(top_n, device=probs.device)
    earlier = (pi > pj) | ((pi == pj) & (li[:, None] > li[None, :]))
    suppressed = ((iou > nms_thresh) & same_class & earlier).any(dim=1)
    keep = ~suppressed
    if thresh is not None:
        keep = keep & (top_probs > thresh)
    return top_boxes, top_probs, top_cls, keep


def device_results_to_lists(
        boxes: np.ndarray, probs: np.ndarray, classes: np.ndarray,
        keep: np.ndarray, num_classes: int,
        plot_prob_thresh: float = None,
) -> Tuple[List[np.ndarray], List[float], List[int]]:
    """One image's fixed-shape results as the grouped-by-class lists the
    reference filter_prediction returns: class 0 first, each class in
    descending-probability order."""
    final_boxes, final_probs, final_cls = [], [], []
    for c in range(num_classes):
        for i in range(len(keep)):
            if keep[i] and classes[i] == c:
                if plot_prob_thresh is not None and \
                        probs[i] <= plot_prob_thresh:
                    continue
                final_boxes.append(boxes[i])
                final_probs.append(float(probs[i]))
                final_cls.append(int(classes[i]))
    return final_boxes, final_probs, final_cls
