"""Non-maximum suppression on the host, in numpy (counterpart of
``squeezedet_tpu/ops/nms.py``).

The reference NMS walks candidates in descending-score order and
suppresses every box that overlaps an earlier candidate by more than the
threshold, without checking whether that earlier candidate survived:

    keep[j]  <=>  no earlier-ordered box i has IoU(i, j) > thresh

The train loop's detection images filter each image's predictions with
:func:`filter_prediction_np`; ``ops/postprocess.py`` is the batched
device formulation of the same rule.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def batch_iou(boxes: np.ndarray, box) -> np.ndarray:
    """IoU of center-format boxes [N, 4] against one box, in numpy.  No
    epsilon, as in the reference: two zero-area boxes divide by zero."""
    lr = np.maximum(
        np.minimum(boxes[:, 0] + 0.5 * boxes[:, 2], box[0] + 0.5 * box[2]) -
        np.maximum(boxes[:, 0] - 0.5 * boxes[:, 2], box[0] - 0.5 * box[2]),
        0)
    tb = np.maximum(
        np.minimum(boxes[:, 1] + 0.5 * boxes[:, 3], box[1] + 0.5 * box[3]) -
        np.maximum(boxes[:, 1] - 0.5 * boxes[:, 3], box[1] - 0.5 * box[3]),
        0)
    inter = lr * tb
    union = boxes[:, 2] * boxes[:, 3] + box[2] * box[3] - inter
    return inter / union


def nms(boxes: np.ndarray, probs: np.ndarray, threshold: float) -> List[bool]:
    """Reference-semantics NMS over center-format boxes: a keep mask in
    input order.  Equal scores walk the larger input position first
    (stable ascending sort, reversed), as the device kernel does."""
    order = probs.argsort(kind="stable")[::-1]
    keep = [True] * len(order)
    for i in range(len(order) - 1):
        ovps = batch_iou(boxes[order[i + 1:]], boxes[order[i]])
        for j, ov in enumerate(ovps):
            if ov > threshold:
                keep[order[j + i + 1]] = False
    return keep


def filter_prediction_np(
    boxes: np.ndarray,
    probs: np.ndarray,
    cls_idx: np.ndarray,
    *,
    classes: int,
    top_n_detection: int,
    prob_thresh: float,
    nms_thresh: float,
) -> Tuple[List[np.ndarray], List[float], List[int]]:
    """Top-N (or prob-threshold) + per-class NMS of one image: boxes,
    probs and classes grouped by class, each class in descending
    probability order of its survivors."""
    if 0 < top_n_detection < len(probs):
        # stable ascending, reversed: ties rank the larger anchor first
        order = probs.argsort(kind="stable")[:-top_n_detection - 1:-1]
        probs = probs[order]
        boxes = boxes[order]
        cls_idx = cls_idx[order]
    else:
        # descending anchor index, for the same tie order as above
        keep_idx = np.nonzero(probs > prob_thresh)[0][::-1]
        probs = probs[keep_idx]
        boxes = boxes[keep_idx]
        cls_idx = cls_idx[keep_idx]

    final_boxes: List[np.ndarray] = []
    final_probs: List[float] = []
    final_cls: List[int] = []
    for c in range(classes):
        idx_per_class = [i for i in range(len(probs)) if cls_idx[i] == c]
        keep = nms(boxes[idx_per_class], probs[idx_per_class], nms_thresh)
        for i in range(len(keep)):
            if keep[i]:
                final_boxes.append(boxes[idx_per_class[i]])
                final_probs.append(probs[idx_per_class[i]])
                final_cls.append(c)
    return final_boxes, final_probs, final_cls
