"""The ConvDet interpretation and the detection filter, from
BichenWuUCB/squeezeDet ``src/nn_skeleton.py`` (``_add_interpretation_graph``)
and ``src/utils/util.py`` (``bbox_transform``, ``bbox_transform_inv``,
``safe_exp``, ``nms``) with ``nn_skeleton.filter_prediction``.

The filter keeps the ``top_n`` most probable anchors, then per class
suppresses every candidate whose IoU with an earlier candidate of its
class (earlier: more probable) is above the threshold: the published
``nms`` loop, which lets a suppressed box suppress later ones too,
written as one pairwise test.  Equal probabilities rank the larger
anchor index, and then the larger position, first.
"""

from __future__ import annotations

import math

import torch


def anchors(cfg, device):
    """[A, 4] (cx, cy, w, h) float32: centers at ``i * W / (Gw + 1)``,
    ``i = 1..Gw`` (and so for y), the shape table at every cell, index
    ``(row * Gw + col) * APG + shape``."""
    from portbench.reference import network
    gh, gw = network(cfg).grid(cfg)
    shapes = torch.tensor(cfg["anchor_shapes"], dtype=torch.float64)
    cx = torch.arange(1, gw + 1, dtype=torch.float64) * cfg["image_width"] \
        / (gw + 1)
    cy = torch.arange(1, gh + 1, dtype=torch.float64) * cfg["image_height"] \
        / (gh + 1)
    n = shapes.shape[0]
    out = torch.stack([
        cx[None, :, None].expand(gh, gw, n),
        cy[:, None, None].expand(gh, gw, n),
        shapes[None, None, :, 0].expand(gh, gw, n),
        shapes[None, None, :, 1].expand(gh, gw, n)], dim=3).reshape(-1, 4)
    return out.to(device, torch.float32)


def safe_exp(w, thresh):
    """exp(w) up to ``thresh``, then the line through it with its slope."""
    return torch.where(w > thresh,
                       math.exp(thresh) * (w - thresh + 1.0),
                       torch.exp(torch.clamp(w, max=thresh)))


def interpret(cfg, preds, anchor_box):
    """Raw head output [B, Hg, Wg, APG * (C + 5)] -> dict of
    ``class_logits`` [B, A, C], ``class_probs``, ``conf`` [B, A] (and
    ``conf_logits``),
    ``deltas`` [B, A, 4], ``boxes`` [B, A, 4] (cx, cy, w, h, clipped to
    the image), ``scores`` [B, A, C] (class prob times confidence)."""
    b = preds.shape[0]
    c, apg = cfg["classes"], cfg["anchor_per_grid"]
    a = anchor_box.shape[0]
    ncp = apg * c
    logits = preds[..., :ncp].reshape(b, a, c)
    probs = torch.softmax(logits, dim=-1)
    conf_logits = preds[..., ncp:ncp + apg].reshape(b, a)
    conf = torch.sigmoid(conf_logits)
    deltas = preds[..., ncp + apg:].reshape(b, a, 4)
    ax, ay, aw, ah = anchor_box.unbind(-1)
    cx = ax + deltas[..., 0] * aw
    cy = ay + deltas[..., 1] * ah
    w = aw * safe_exp(deltas[..., 2], cfg["exp_thresh"])
    h = ah * safe_exp(deltas[..., 3], cfg["exp_thresh"])
    wmax, hmax = cfg["image_width"] - 1.0, cfg["image_height"] - 1.0
    xmin = torch.clamp(torch.clamp(cx - w / 2, min=0.0), max=wmax)
    ymin = torch.clamp(torch.clamp(cy - h / 2, min=0.0), max=hmax)
    xmax = torch.clamp(torch.clamp(cx + w / 2, max=wmax), min=0.0)
    ymax = torch.clamp(torch.clamp(cy + h / 2, max=hmax), min=0.0)
    bw, bh = xmax - xmin + 1.0, ymax - ymin + 1.0
    boxes = torch.stack([xmin + 0.5 * bw, ymin + 0.5 * bh, bw, bh], dim=-1)
    return {"class_logits": logits, "class_probs": probs, "conf": conf,
            "conf_logits": conf_logits,
            "deltas": deltas, "boxes": boxes,
            "scores": probs * conf[..., None]}


def pairwise_iou(boxes):
    """[..., K, 4] center boxes -> [..., K, K] IoU."""
    x1 = boxes[..., 0] - boxes[..., 2] / 2
    x2 = boxes[..., 0] + boxes[..., 2] / 2
    y1 = boxes[..., 1] - boxes[..., 3] / 2
    y2 = boxes[..., 1] + boxes[..., 3] / 2
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    inter = iw * ih
    area = boxes[..., 2] * boxes[..., 3]
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def suppressed(boxes, probs, classes, thresh, margin=0.0):
    """[B, K] bool: candidate j overlaps, by an IoU above ``thresh +
    margin``, an earlier candidate of its class (the published ``nms``
    on candidates in the given order)."""
    iou = pairwise_iou(boxes.double())
    same = classes[..., :, None] == classes[..., None, :]
    pi, pj = probs[..., :, None], probs[..., None, :]
    pos = torch.arange(probs.shape[-1], device=probs.device)
    earlier = (pi > pj) | ((pi == pj) & (pos[:, None] > pos[None, :]))
    return ((iou > thresh + margin) & same & earlier).any(dim=-2)


def filter_top(cfg, interp):
    """The detection filter over ``interp``: (boxes [B, K, 4], probs
    [B, K], classes [B, K], keep [B, K]) of the ``top_n`` most probable
    anchors, in descending probability."""
    best, cls = interp["scores"].max(dim=-1)
    a = best.shape[1]
    k = min(cfg["top_n_detection"], a)
    # ties: the larger anchor index first
    top, rev = torch.sort(best.flip(1), dim=1, descending=True, stable=True)
    order = a - 1 - rev[:, :k]
    boxes = torch.gather(interp["boxes"], 1, order[..., None].expand(-1, -1, 4))
    probs, classes = top[:, :k], torch.gather(cls, 1, order)
    keep = ~suppressed(boxes, probs, classes, cfg["nms_thresh"])
    if k >= a:
        keep &= probs > cfg["prob_thresh"]
    return boxes, probs, classes, keep
