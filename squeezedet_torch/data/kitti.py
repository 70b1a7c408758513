"""KITTI dataset: the image set and its annotations (counterpart of
``squeezedet_tpu/data/kitti.py``).

Labels parse as the reference's: difficulty levels from height,
truncation and occlusion (hard examples dropped under
``exclude_hard_examples``), boxes stored center-format with the +1
convention.  Detection files, scoring and error analysis belong to eval
and raise until it is ported (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import os
from typing import Dict, List

from squeezedet_torch.data.imdb import Imdb


def bbox_transform_inv(bbox):
    """Corners (xmin, ymin, xmax, ymax) -> center (cx, cy, w, h), with the
    reference's +1 convention: a box over pixel columns xmin..xmax is
    xmax - xmin + 1 wide."""
    xmin, ymin, xmax, ymax = bbox
    width = xmax - xmin + 1.0
    height = ymax - ymin + 1.0
    return [xmin + 0.5 * width, ymin + 0.5 * height, width, height]


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


def _eval_not_ported(what: str):
    return NotImplementedError(
        "Kitti.{} belongs to eval: ROADMAP Queue 1 item 9".format(what))


class Kitti(Imdb):
    def __init__(self, image_set: str, data_path: str, mc, rng=None):
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

    # -- evaluation (ROADMAP Queue 1 item 9) --------------------------------
    def write_detection_files(self, det_file_dir, all_boxes):
        raise _eval_not_ported("write_detection_files")

    def run_scorer(self, result_dir):
        raise _eval_not_ported("run_scorer")

    def evaluate_detections(self, eval_dir, global_step, all_boxes):
        raise _eval_not_ported("evaluate_detections")

    def do_detection_analysis_in_eval(self, eval_dir, global_step):
        raise _eval_not_ported("do_detection_analysis_in_eval")

    def analyze_detections(self, detection_file_dir, det_error_file):
        raise _eval_not_ported("analyze_detections")
