"""KITTI dataset: annotation loading, detection-file writing, the official
mAP scoring and error analysis (counterpart of
``squeezedet_tpu/data/kitti.py``).

Labels parse as the reference's: difficulty levels from height,
truncation and occlusion (hard examples dropped under
``exclude_hard_examples``), boxes stored center-format with the +1
convention.  :meth:`Kitti.evaluate_detections` writes one KITTI-format
det file per image, scores them and parses ``stats_{cls}_ap.txt`` into 9
APs.  The scorer is the C++ evaluator (``native/kitti_eval``), built from
the port's copy of its source at first use; where it cannot be built,
the bit-equivalent Python scorer (``kitti_ap.py``) runs in-process.
:meth:`Kitti.run_scorer` returns which one ran.
"""

from __future__ import annotations

import os
import subprocess
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from squeezedet_torch.data.imdb import Imdb
from squeezedet_torch.ops.nms import batch_iou
from squeezedet_torch.utils.util import bbox_transform_inv

NATIVE, PYTHON = "native", "python"


def get_obj_level(obj: List[str]) -> int:
    """KITTI difficulty level 1..4 of a parsed label line."""
    height = float(obj[7]) - float(obj[5]) + 1
    truncation = float(obj[1])
    occlusion = float(obj[2])
    if height >= 40 and truncation <= 0.15 and occlusion <= 0:
        return 1
    elif height >= 25 and truncation <= 0.3 and occlusion <= 1:
        return 2
    elif height >= 25 and truncation <= 0.5 and occlusion <= 2:
        return 3
    else:
        return 4


class Kitti(Imdb):
    """``eval_tool`` is the evaluator binary to run: None builds the
    port's own (``native.build_kitti_eval``); a path that does not exist
    (e.g. ``""``) selects the in-process Python scorer, as in the JAX
    package."""

    def __init__(self, image_set: str, data_path: str, mc, rng=None,
                 eval_tool: Optional[str] = None):
        super().__init__('kitti_' + image_set, mc, rng=rng)
        self._image_set = image_set
        self._data_root_path = data_path
        self._image_path = os.path.join(data_path, 'training', 'image_2')
        self._label_path = os.path.join(data_path, 'training', 'label_2')
        self._classes = mc.class_names
        self._class_to_idx = dict(zip(self._classes,
                                      range(self.num_classes)))
        self._image_idx = self._load_image_set_idx()
        self._rois = self._load_kitti_annotation()
        self._shuffle_image_idx()
        self._eval_tool = eval_tool
        self.scorer_used: Optional[str] = None

    def _load_image_set_idx(self) -> List[str]:
        image_set_file = os.path.join(
            self._data_root_path, 'ImageSets', self._image_set + '.txt')
        if not os.path.exists(image_set_file):
            raise FileNotFoundError(
                'File does not exist: {}'.format(image_set_file))
        with open(image_set_file) as f:
            return [x.strip() for x in f.readlines()]

    def _image_path_at(self, idx: str) -> str:
        image_path = os.path.join(self._image_path, idx + '.png')
        if not os.path.exists(image_path):
            raise FileNotFoundError(
                'Image does not exist: {}'.format(image_path))
        return image_path

    def _load_kitti_annotation(self) -> Dict[str, list]:
        idx2annotation = {}
        for index in self._image_idx:
            filename = os.path.join(self._label_path, index + '.txt')
            with open(filename) as f:
                lines = f.readlines()
            bboxes = []
            for line in lines:
                obj = line.strip().split(' ')
                try:
                    cls = self._class_to_idx[obj[0].lower().strip()]
                except KeyError:
                    continue
                if self.mc.exclude_hard_examples and get_obj_level(obj) > 3:
                    continue
                xmin, ymin = float(obj[4]), float(obj[5])
                xmax, ymax = float(obj[6]), float(obj[7])
                if not (0.0 <= xmin <= xmax and 0.0 <= ymin <= ymax):
                    raise ValueError(
                        'Invalid bounding box ({}, {}, {}, {}) at '
                        '{}.txt'.format(xmin, ymin, xmax, ymax, index))
                x, y, w, h = bbox_transform_inv([xmin, ymin, xmax, ymax])
                bboxes.append([x, y, w, h, cls])
            idx2annotation[index] = bboxes
        return idx2annotation

    # -- evaluation ---------------------------------------------------------
    def write_detection_files(self, det_file_dir: str, all_boxes) -> None:
        """One KITTI-format txt per image."""
        os.makedirs(det_file_dir, exist_ok=True)
        for im_idx, index in enumerate(self._image_idx):
            filename = os.path.join(det_file_dir, index + '.txt')
            with open(filename, 'wt') as f:
                for cls_idx, cls in enumerate(self._classes):
                    dets = all_boxes[cls_idx][im_idx]
                    for k in range(len(dets)):
                        f.write(
                            '{:s} -1 -1 0.0 {:.2f} {:.2f} {:.2f} {:.2f} 0.0 '
                            '0.0 0.0 0.0 0.0 0.0 0.0 {:.3f}\n'.format(
                                cls.lower(), dets[k][0], dets[k][1],
                                dets[k][2], dets[k][3], dets[k][4]))

    def _native_tool(self) -> Optional[str]:
        """The evaluator binary to run, or None for the Python scorer."""
        if self._eval_tool is not None:
            return self._eval_tool if os.path.exists(self._eval_tool) \
                else None
        from squeezedet_torch.native import build_kitti_eval
        try:
            return build_kitti_eval()
        except (OSError, RuntimeError) as e:
            print('Could not build native evaluator ({}); using the python '
                  'scorer'.format(e))
            return None

    def run_scorer(self, result_dir: str) -> str:
        """Score ``result_dir/data`` with the native evaluator, or the
        in-process Python scorer where it cannot be built.  Returns (and
        records in ``scorer_used``) ``"native"`` or ``"python"``; raises
        if the native evaluator fails."""
        gt_training_dir = os.path.join(self._data_root_path, 'training')
        image_set_file = os.path.join(self._data_root_path, 'ImageSets',
                                      self._image_set + '.txt')
        n = len(self._image_idx)
        tool = self._native_tool()
        if tool is not None:
            cmd = [tool, gt_training_dir, image_set_file, result_dir, str(n)]
            print('Running: {}'.format(' '.join(cmd)))
            subprocess.check_call(cmd)
            self.scorer_used = NATIVE
        else:
            from squeezedet_torch.data.kitti_ap import evaluate
            print('Native evaluator not available; using the in-process '
                  'scorer')
            evaluate(result_dir, image_set_file,
                     os.path.join(gt_training_dir, 'label_2'), n)
            self.scorer_used = PYTHON
        print('Scored by the {} scorer'.format(self.scorer_used))
        return self.scorer_used

    def evaluate_detections(self, eval_dir: str, global_step,
                            all_boxes) -> Tuple[List[float], List[str]]:
        """Write det files, score, parse 9 APs.

        all_boxes[cls][image] = list of [xmin, ymin, xmax, ymax, score].
        """
        det_file_dir = os.path.join(
            eval_dir, 'detection_files_{:s}'.format(str(global_step)),
            'data')
        self.write_detection_files(det_file_dir, all_boxes)
        result_dir = os.path.dirname(det_file_dir)
        self.run_scorer(result_dir)

        aps, names = [], []
        for cls in self._classes:
            det_file_name = os.path.join(
                result_dir, 'stats_{:s}_ap.txt'.format(cls))
            if os.path.exists(det_file_name):
                with open(det_file_name) as f:
                    lines = f.readlines()
                if len(lines) != 3:
                    raise ValueError('{} has {} lines, not 3'.format(
                        det_file_name, len(lines)))
                aps.extend(float(line.split('=')[1].strip())
                           for line in lines)
            else:
                aps.extend([0.0, 0.0, 0.0])
            names.extend([cls + '_easy', cls + '_medium', cls + '_hard'])
        return aps, names

    # -- error analysis ------------------------------------------------------
    def do_detection_analysis_in_eval(self, eval_dir, global_step):
        det_file_dir = os.path.join(
            eval_dir, 'detection_files_{:s}'.format(str(global_step)),
            'data')
        det_error_dir = os.path.join(
            eval_dir, 'detection_files_{:s}'.format(str(global_step)),
            'error_analysis')
        os.makedirs(det_error_dir, exist_ok=True)
        det_error_file = os.path.join(det_error_dir, 'det_error_file.txt')
        stats = self.analyze_detections(det_file_dir, det_error_file)
        ims = self.visualize_detections(
            image_dir=self._image_path, image_format='.png',
            det_error_file=det_error_file,
            output_image_dir=det_error_dir, num_det_per_type=10)
        return stats, ims

    def _load_detection_rois(self, detection_file_dir):
        """Read the per-image KITTI det files back as score-descending
        center-format rows [cx, cy, w, h, cls, score]."""
        rois = {}
        for idx in self._image_idx:
            path = os.path.join(detection_file_dir, idx + '.txt')
            rows = []
            with open(path) as f:
                for line in f:
                    fields = line.split()
                    if not fields:
                        continue
                    cls = self._class_to_idx[fields[0].lower()]
                    corners = [float(v) for v in fields[4:8]]
                    cx, cy, w, h = bbox_transform_inv(corners)
                    rows.append([cx, cy, w, h, cls, float(fields[-1])])
            rows.sort(key=lambda r: r[-1], reverse=True)
            rois[idx] = rows
        return rois

    @staticmethod
    def _audit_one_detection(det, gt_bboxes, claimed):
        """Label one detection against an image's GT set.

        Returns one of 'bg' (best IoU <= 0.1), 'cls' (overlaps a GT of a
        different class), 'loc' (right class, IoU in (0.1, 0.5)),
        'repeated' (duplicate claim) or 'correct' (marks the GT claimed).
        """
        overlaps = batch_iou(gt_bboxes[:, :4], det[:4])
        j = int(np.argmax(overlaps))
        best = float(overlaps[j])
        if best <= 0.1:
            return 'bg', j
        if gt_bboxes[j, 4] != det[4]:
            return 'cls', j
        if best < 0.5:
            return 'loc', j
        if claimed[j]:
            return 'repeated', j
        claimed[j] = True
        return 'correct', j

    def analyze_detections(self, detection_file_dir, det_error_file):
        """Detection-error taxonomy over a scored split.

        Per image, only the ``len(gt)`` highest-scoring detections are
        audited, each against its best-IoU ground truth, with 0.1/0.5 IoU
        bands separating background / localization / classification /
        repeated errors from correct detections.  Loc/cls/bg errors and
        undetected ('missed') GT are appended to ``det_error_file`` for
        the visualization gallery.  The summary ratios are zero on empty
        inputs.
        """
        self._det_rois = self._load_detection_rois(detection_file_dir)

        tally = Counter()
        audited = objects = found = 0

        def _emit(f, idx, kind, row, score):
            cx, cy, w, h = row[0], row[1], row[2], row[3]
            f.write('{} {} {:.1f} {:.1f} {:.1f} {:.1f} {} {:.3f}\n'.format(
                idx, kind, cx - w / 2., cy - h / 2., cx + w / 2.,
                cy + h / 2., self._classes[int(row[4])], score))

        with open(det_error_file, 'w') as f:
            for idx in self._image_idx:
                gt_bboxes = np.array(self._rois[idx])
                objects += len(gt_bboxes)
                if len(gt_bboxes) == 0:
                    continue
                claimed = np.zeros(len(gt_bboxes), bool)
                for det in self._det_rois[idx][:len(gt_bboxes)]:
                    kind, _ = self._audit_one_detection(det, gt_bboxes,
                                                        claimed)
                    tally[kind] += 1
                    audited += 1
                    if kind in ('loc', 'cls', 'bg'):
                        _emit(f, idx, kind, det, det[5])
                for gt_row, was_claimed in zip(gt_bboxes, claimed):
                    if not was_claimed:
                        _emit(f, idx, 'missed', gt_row, -1.0)
                found += int(np.count_nonzero(claimed))

        def _ratio(n, d):
            return n / d if d else 0.0

        stats = {
            'num of detections': float(audited),
            'num of objects': float(objects),
            '% correct detections': _ratio(tally['correct'], audited),
            '% localization error': _ratio(tally['loc'], audited),
            '% classification error': _ratio(tally['cls'], audited),
            '% background error': _ratio(tally['bg'], audited),
            '% repeated error': _ratio(tally['repeated'], audited),
            '% recall': _ratio(found, objects),
        }
        print('Detection Analysis:')
        for key, value in stats.items():
            print('    {}: {}'.format(key, value))
        return stats
