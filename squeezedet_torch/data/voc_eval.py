"""Pascal VOC average-precision scoring (a copy of
``squeezedet_tpu/data/voc_eval.py``).

Implements the standard VOC detection protocol (the same one the
reference vendors at ``src/dataset/voc_eval.py``, which in turn derives
from the MIT-licensed Faster R-CNN codebase): detections for one class
are ranked by score across the whole split and greedily matched to the
best-overlapping ground-truth box of that class in their image; a match
above the overlap threshold is a true positive the first time the box is
claimed, a duplicate afterwards, and ``difficult`` ground truth absorbs
matches without counting either way.  AP is either the VOC07 11-point
sample mean or the area under the monotone precision envelope.

Overlap uses the VOC inclusive-pixel convention (a box spanning columns
``xmin..xmax`` is ``xmax - xmin + 1`` wide), which is the same +1
convention as this package's center-format box library — so the overlap
here is ``ops.nms.batch_iou`` after a corner->center conversion.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from squeezedet_torch.ops.nms import batch_iou


def _int_text(node, tag: str, default: int = 0) -> int:
    """int() via float(): labeling tools commonly emit decimal
    coordinates ('<xmin>156.00</xmin>'), which int() rejects."""
    child = node.find(tag)
    return int(float(child.text)) if child is not None else default


def parse_rec(filename: str) -> List[dict]:
    """Parse one VOC annotation XML into a list of object records with
    keys ``name``/``pose``/``truncated``/``difficult``/``bbox`` (corner
    ints), the record shape the scorer consumes."""
    import xml.etree.ElementTree as ET

    records = []
    for obj in ET.parse(filename).findall('object'):
        box = obj.find('bndbox')
        pose = obj.find('pose')
        records.append({
            'name': obj.find('name').text,
            'pose': pose.text if pose is not None else '',
            'truncated': _int_text(obj, 'truncated'),
            'difficult': _int_text(obj, 'difficult'),
            'bbox': [_int_text(box, t) for t in
                     ('xmin', 'ymin', 'xmax', 'ymax')],
        })
    return records


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a recall/precision curve.

    VOC07 mode samples the max precision at recall >= t for the 11
    thresholds t in {0, 0.1, ..., 1.0}; otherwise integrates the area
    under the monotonically-decreasing precision envelope.
    """
    if use_07_metric:
        samples = [np.max(precision[recall >= t], initial=0.0)
                   for t in np.linspace(0.0, 1.0, 11)]
        return float(np.mean(samples))
    r = np.concatenate(([0.0], recall, [1.0]))
    p = np.concatenate(([0.0], precision, [0.0]))
    envelope = np.maximum.accumulate(p[::-1])[::-1]
    dr = np.diff(r)
    steps = np.flatnonzero(dr)
    return float(np.sum(dr[steps] * envelope[steps + 1]))


@dataclass
class _ImageGt:
    """Per-image ground truth for one class, in center format."""
    boxes: np.ndarray       # [n, 4] (cx, cy, w, h) with the +1 convention
    difficult: np.ndarray   # [n] bool
    claimed: np.ndarray     # [n] bool, set as detections match


def _center(corners: Sequence[float]) -> List[float]:
    xmin, ymin, xmax, ymax = corners
    w = xmax - xmin + 1.0
    h = ymax - ymin + 1.0
    return [xmin + 0.5 * w, ymin + 0.5 * h, w, h]


def _read_image_set(imagesetfile: str) -> List[str]:
    with open(imagesetfile) as f:
        return [line.strip() for line in f if line.strip()]


def _cached_annotations(cachedir: str, annopath: str,
                        names: Sequence[str]) -> Dict[str, list]:
    """All images' parsed annotations, cached as one npz per split dir."""
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(cachedir, 'annots.npz')
    if os.path.isfile(cachefile):
        return np.load(cachefile, allow_pickle=True)['recs'][0]
    recs = {name: parse_rec(annopath.format(name)) for name in names}
    np.savez_compressed(cachefile, recs=np.array([recs], dtype=object))
    return recs


def _load_class_detections(
        detfile: str) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Det-file rows -> (image ids, scores, corner boxes [n, 4])."""
    ids: List[str] = []
    scores: List[float] = []
    boxes: List[List[float]] = []
    with open(detfile) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            ids.append(fields[0])
            scores.append(float(fields[1]))
            boxes.append([float(v) for v in fields[2:6]])
    return ids, np.asarray(scores), np.asarray(boxes).reshape(len(ids), 4)


def voc_eval(detpath: str, annopath: str, imagesetfile: str,
             classname: str, cachedir: str, ovthresh: float = 0.5,
             use_07_metric: bool = False):
    """Score one class's detections against a VOC split.

    ``detpath``/``annopath`` are templates with a ``{}`` slot for the
    class / image name.  Returns ``(recall, precision, ap)``.
    """
    names = _read_image_set(imagesetfile)
    recs = _cached_annotations(cachedir, annopath, names)

    gt_by_image: Dict[str, _ImageGt] = {}
    total_positives = 0
    for name in names:
        objs = [o for o in recs[name] if o['name'] == classname]
        boxes = np.array([_center(o['bbox']) for o in objs],
                         np.float64).reshape(len(objs), 4)
        difficult = np.array([bool(o['difficult']) for o in objs], bool)
        gt_by_image[name] = _ImageGt(boxes, difficult,
                                     np.zeros(len(objs), bool))
        total_positives += int(np.count_nonzero(~difficult))

    ids, scores, det_corners = _load_class_detections(
        detpath.format(classname))
    if not ids:
        return np.array([]), np.array([]), 0.0

    order = np.argsort(-scores)
    hit = np.zeros(len(ids))
    miss = np.zeros(len(ids))
    for rank, d in enumerate(order):
        gt = gt_by_image[ids[d]]
        if len(gt.boxes) == 0:
            miss[rank] = 1.0
            continue
        overlaps = batch_iou(gt.boxes, _center(det_corners[d]))
        j = int(np.argmax(overlaps))
        if overlaps[j] <= ovthresh:
            miss[rank] = 1.0
        elif gt.difficult[j]:
            pass  # difficult GT absorbs the detection: neither tp nor fp
        elif gt.claimed[j]:
            miss[rank] = 1.0  # duplicate of an already-matched box
        else:
            hit[rank] = 1.0
            gt.claimed[j] = True

    tp = np.cumsum(hit)
    fp = np.cumsum(miss)
    recall = tp / float(total_positives)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)
