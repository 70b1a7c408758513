"""Pure-Python KITTI detection mAP scorer (a copy of
``squeezedet_tpu/data/kitti_ap.py``, which the port cannot import: the
JAX package's ``__init__`` imports jax).

Implements the official KITTI evaluation protocol as the native
evaluator (``native/kitti_eval/evaluate_object.cc``) does: per class x
difficulty, 41-point recall discretization, two-pass TP/FP/FN statistics
with neighboring-class ignores (Van<->Car, Person_sitting<->Pedestrian)
and DontCare absorption, cumulative-max precision filtering and 11-point
AP sampled every 4th of the 41 points.

This runs in-process when the C++ binary cannot be built, and doubles as
the parity oracle for it.  Outputs: ``stats_{cls}_ap.txt`` (3 lines
``AP=<x>``), ``stats_{cls}_detection.txt`` (3 rows of 11 precisions) and
``plot/{cls}_detection.txt`` PR-curve data, byte for byte what the JAX
package's scorer writes (``tests/test_torch_kitti_eval.py``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

CLASS_NAMES = ("car", "pedestrian", "cyclist")
MIN_HEIGHT = (40, 25, 25)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
MIN_OVERLAP = {"car": 0.7, "pedestrian": 0.5, "cyclist": 0.5}
N_SAMPLE_PTS = 41
_NO_DETECTION = -10000000.0


@dataclass
class GtBox:
    type: str
    truncation: float
    occlusion: int
    alpha: float
    x1: float
    y1: float
    x2: float
    y2: float


@dataclass
class DetBox:
    type: str
    alpha: float
    x1: float
    y1: float
    x2: float
    y2: float
    score: float


def load_groundtruth(path: str) -> List[GtBox]:
    out = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 15:
                continue
            out.append(GtBox(p[0], float(p[1]), int(float(p[2])),
                             float(p[3]), float(p[4]), float(p[5]),
                             float(p[6]), float(p[7])))
    return out


def load_detections(path: str) -> List[DetBox]:
    out = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 16:
                continue
            out.append(DetBox(p[0], float(p[3]), float(p[4]), float(p[5]),
                              float(p[6]), float(p[7]), float(p[15])))
    return out


def box_overlap(a, b, criterion: int = -1) -> float:
    """IoU (criterion -1) or intersection/area_a (criterion 0)
    (evaluate_object.cpp:203-237)."""
    x1, y1 = max(a.x1, b.x1), max(a.y1, b.y1)
    x2, y2 = min(a.x2, b.x2), min(a.y2, b.y2)
    w, h = x2 - x1, y2 - y1
    if w <= 0 or h <= 0:
        return 0.0
    inter = w * h
    a_area = (a.x2 - a.x1) * (a.y2 - a.y1)
    b_area = (b.x2 - b.x1) * (b.y2 - b.y1)
    if criterion == -1:
        return inter / (a_area + b_area - inter)
    if criterion == 0:
        return inter / a_area
    return inter / b_area


def get_thresholds(scores: List[float], n_gt: float) -> List[float]:
    """Recall-discretized score thresholds (evaluate_object.cpp:239-272)."""
    v = sorted(scores, reverse=True)
    t: List[float] = []
    current_recall = 0.0
    for i in range(len(v)):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(v) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) \
                and i < len(v) - 1:
            continue
        t.append(v[i])
        current_recall += 1.0 / (N_SAMPLE_PTS - 1.0)
    return t


def clean_data(cls: str, gt: List[GtBox], det: List[DetBox],
               difficulty: int):
    """Classify gt as valid(0)/ignored(1)/other(-1), collect DontCare,
    mark dets of other classes (evaluate_object.cpp:274-343).
    Returns (ignored_gt, dontcare, ignored_det, n_gt_increment)."""
    ignored_gt, dc, ignored_det = [], [], []
    n_gt = 0
    for g in gt:
        height = g.y2 - g.y1
        gtype = g.type.lower()
        if gtype == cls:
            valid_class = 1
        elif cls == "pedestrian" and gtype == "person_sitting":
            valid_class = 0
        elif cls == "car" and gtype == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (g.occlusion > MAX_OCCLUSION[difficulty]
                  or g.truncation > MAX_TRUNCATION[difficulty]
                  or height < MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            n_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
    for g in gt:
        if g.type.lower() == "dontcare":
            dc.append(g)
    for d in det:
        ignored_det.append(0 if d.type.lower() == cls else -1)
    return ignored_gt, dc, ignored_det, n_gt


def compute_statistics(cls: str, gt: List[GtBox], det: List[DetBox],
                       dc: List[GtBox], ignored_gt: List[int],
                       ignored_det: List[int], compute_fp: bool,
                       compute_aos: bool = False, thresh: float = 0.0):
    """One image's TP/FP/FN (+ AOS similarity) at a score threshold
    (evaluate_object.cpp:345-498).  Returns (tp, fp, fn, similarity,
    tp_scores)."""
    min_overlap = MIN_OVERLAP[cls]
    tp = fp = fn = 0
    tp_scores: List[float] = []
    delta: List[float] = []
    assigned = [False] * len(det)
    ignored_threshold = [compute_fp and d.score < thresh for d in det]

    for i, g in enumerate(gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j, d in enumerate(det):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = box_overlap(d, g)
            if not compute_fp and overlap > min_overlap \
                    and d.score > valid_detection:
                det_idx = j
                valid_detection = d.score
            elif compute_fp and overlap > min_overlap \
                    and (overlap > max_overlap or assigned_ignored_det) \
                    and ignored_det[j] == 0:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif compute_fp and overlap > min_overlap \
                    and valid_detection == _NO_DETECTION \
                    and ignored_det[j] == 1:
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != _NO_DETECTION and \
                (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            tp_scores.append(det[det_idx].score)
            if compute_aos:
                delta.append(g.alpha - det[det_idx].alpha)
            assigned[det_idx] = True

    similarity = 0.0
    if compute_fp:
        for j in range(len(det)):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        for d_area in dc:
            for j, d in enumerate(det):
                if assigned[j] or ignored_det[j] in (-1, 1) \
                        or ignored_threshold[j]:
                    continue
                if box_overlap(d, d_area, 0) > min_overlap:
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [0.0] * fp + [(1.0 + math.cos(dlt)) / 2.0
                                for dlt in delta]
            similarity = sum(tmp) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, tp_scores


def eval_class(cls: str, groundtruth: List[List[GtBox]],
               detections: List[List[DetBox]], difficulty: int,
               compute_aos: bool = False
               ) -> Tuple[List[float], List[float]]:
    """Full PR curve for one class x difficulty
    (evaluate_object.cpp:504-581).  Returns (precision[41], aos[41])."""
    n_images = len(groundtruth)
    n_gt = 0
    scores: List[float] = []
    all_ignored_gt, all_ignored_det, all_dc = [], [], []
    for i in range(n_images):
        i_gt, dc, i_det, inc = clean_data(cls, groundtruth[i],
                                          detections[i], difficulty)
        n_gt += inc
        all_ignored_gt.append(i_gt)
        all_ignored_det.append(i_det)
        all_dc.append(dc)
        _, _, _, _, tp_scores = compute_statistics(
            cls, groundtruth[i], detections[i], dc, i_gt, i_det, False)
        scores.extend(tp_scores)

    thresholds = get_thresholds(scores, n_gt)
    tps = [0] * len(thresholds)
    fps = [0] * len(thresholds)
    fns = [0] * len(thresholds)
    sims = [0.0] * len(thresholds)
    for i in range(n_images):
        for t, thr in enumerate(thresholds):
            tp, fp, fn, sim, _ = compute_statistics(
                cls, groundtruth[i], detections[i], all_dc[i],
                all_ignored_gt[i], all_ignored_det[i], True,
                compute_aos, thr)
            tps[t] += tp
            fps[t] += fp
            fns[t] += fn
            if sim != -1:
                sims[t] += sim

    precision = [0.0] * N_SAMPLE_PTS
    aos = [0.0] * N_SAMPLE_PTS
    for i in range(len(thresholds)):
        # tp+fp can be 0 at a threshold whose sole detection is absorbed
        # by an ignored GT or DontCare region in the second pass; the C++
        # devkit computes 0/0 = NaN there (evaluate_object.cpp:567) and
        # the max-envelope below ignores NaN candidates the same way
        # std::max_element does, so mirror NaN instead of raising.
        denom = float(tps[i] + fps[i])
        precision[i] = tps[i] / denom if denom else float("nan")
        if compute_aos:
            aos[i] = sims[i] / denom if denom else float("nan")
    # cumulative max from the right, only over threshold-covered entries
    for i in range(len(thresholds)):
        precision[i] = max(precision[i:])
        if compute_aos:
            aos[i] = max(aos[i:])
    return precision, aos


def ap_from_precision(precision: List[float]) -> float:
    """11-point AP: mean of precision[0], [4], ..., [40]
    (evaluate_object.cpp:171-186)."""
    pts = [precision[i] for i in range(0, len(precision), 4)]
    assert len(pts) == 11
    return sum(pts) / 11.0


def evaluate(result_dir: str, image_set_filename: str, gt_dir: str,
             n_images: Optional[int] = None,
             classes: Tuple[str, ...] = CLASS_NAMES) -> Dict[str, list]:
    """Score a result directory; same inputs/outputs as the native
    evaluator's CLI (evaluate_object.cpp:645-782).

    result_dir must contain data/<index>.txt detection files; writes
    stats_{cls}_ap.txt / stats_{cls}_detection.txt / plot data there.
    Returns {cls: [AP_easy, AP_moderate, AP_hard]}.
    """
    with open(image_set_filename) as f:
        image_set = [x.strip() for x in f if x.strip()]
    if n_images is not None and len(image_set) != n_images:
        raise ValueError("image set has {} entries, expected {}".format(
            len(image_set), n_images))
    plot_dir = os.path.join(result_dir, "plot")
    os.makedirs(plot_dir, exist_ok=True)

    groundtruth, detections = [], []
    compute_aos = True
    seen = {c: False for c in classes}
    for idx in image_set:
        groundtruth.append(
            load_groundtruth(os.path.join(gt_dir, idx + ".txt")))
        det = load_detections(
            os.path.join(result_dir, "data", idx + ".txt"))
        detections.append(det)
        for d in det:
            if d.alpha == -10:
                compute_aos = False
            t = d.type.lower()
            if t in seen:
                seen[t] = True

    results: Dict[str, list] = {}
    for cls in classes:
        if not seen.get(cls, False):
            continue
        precisions, aoses, aps = [], [], []
        for difficulty in range(3):
            prec, aos = eval_class(cls, groundtruth, detections,
                                   difficulty, compute_aos)
            precisions.append(prec)
            aoses.append(aos)
            aps.append(ap_from_precision(prec))
        results[cls] = aps

        with open(os.path.join(result_dir,
                               "stats_{}_ap.txt".format(cls)), "w") as f:
            for ap in aps:
                f.write("AP={:.6g}\n".format(ap))
        with open(os.path.join(
                result_dir, "stats_{}_detection.txt".format(cls)),
                "w") as f:
            for prec in precisions:
                f.write(" ".join("%f" % prec[i]
                                 for i in range(0, N_SAMPLE_PTS, 4)) + " \n")
        if compute_aos:
            with open(os.path.join(
                    result_dir, "stats_{}_orientation.txt".format(cls)),
                    "w") as f:
                for aos in aoses:
                    f.write(" ".join("%f" % a for a in aos) + " \n")
        with open(os.path.join(
                plot_dir, "{}_detection.txt".format(cls)), "w") as f:
            for i in range(N_SAMPLE_PTS):
                f.write("%f %f %f %f\n" % (
                    i / (N_SAMPLE_PTS - 1.0), precisions[0][i],
                    precisions[1][i], precisions[2][i]))
        if compute_aos:
            with open(os.path.join(
                    plot_dir, "{}_orientation.txt".format(cls)), "w") as f:
                for i in range(N_SAMPLE_PTS):
                    f.write("%f %f %f %f\n" % (
                        i / (N_SAMPLE_PTS - 1.0), aoses[0][i],
                        aoses[1][i], aoses[2][i]))
    return results
