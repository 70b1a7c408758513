"""Pascal VOC dataset wrapper (counterpart of
``squeezedet_tpu/data/pascal_voc.py``): loads a
``VOC<year>`` split, drops ``difficult`` objects, stores 0-based
center-format ground truth, and evaluates detections with the in-package
VOC scorer (11-point metric for years before 2010).  The XML parsing is
shared with the scorer (``voc_eval.parse_rec``) rather than duplicated,
and annotation problems raise ``ValueError`` with the offending file.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from squeezedet_torch.data import voc_eval
from squeezedet_torch.data.imdb import Imdb
from squeezedet_torch.utils.util import bbox_transform_inv


class PascalVoc(Imdb):
    def __init__(self, image_set: str, year: str, data_path: str, mc,
                 rng=None):
        super().__init__('voc_{}_{}'.format(year, image_set), mc, rng=rng)
        self._year = year
        self._image_set = image_set
        self._data_root_path = data_path
        self._data_path = os.path.join(data_path, 'VOC' + year)
        self._classes = mc.class_names
        self._class_to_idx = {name: i
                              for i, name in enumerate(self._classes)}
        self._image_idx = self._read_split()
        self._rois = {idx: self._ground_truth_for(idx)
                      for idx in self._image_idx}
        self._shuffle_image_idx()

    @property
    def year(self):
        return self._year

    # -- loading -----------------------------------------------------------
    def _read_split(self) -> List[str]:
        split_file = os.path.join(self._data_path, 'ImageSets', 'Main',
                                  self._image_set + '.txt')
        if not os.path.exists(split_file):
            raise FileNotFoundError(
                'VOC image-set file missing: {}'.format(split_file))
        with open(split_file) as f:
            return [line.strip() for line in f if line.strip()]

    def _image_path_at(self, idx: str) -> str:
        path = os.path.join(self._data_path, 'JPEGImages', idx + '.jpg')
        if not os.path.exists(path):
            raise FileNotFoundError('VOC image missing: {}'.format(path))
        return path

    def _ground_truth_for(self, idx: str) -> List[list]:
        """Non-difficult objects of one image as [cx, cy, w, h, cls] rows,
        0-based center format (VOC XML coords are 1-based)."""
        xml_path = os.path.join(self._data_path, 'Annotations',
                                idx + '.xml')
        rows = []
        for obj in voc_eval.parse_rec(xml_path):
            if obj['difficult']:
                continue
            corners = [float(v) - 1.0 for v in obj['bbox']]
            xmin, ymin, xmax, ymax = corners
            if not (0.0 <= xmin <= xmax and 0.0 <= ymin <= ymax):
                raise ValueError(
                    'degenerate box {} in {}'.format(corners, xml_path))
            cx, cy, w, h = bbox_transform_inv(corners)
            rows.append([cx, cy, w, h,
                         self._class_to_idx[obj['name'].lower().strip()]])
        return rows

    # -- evaluation --------------------------------------------------------
    def _write_class_det_files(self, det_dir: str, all_boxes) -> str:
        """One det file per class; rows are ``id score x1 y1 x2 y2`` with
        1-based corners, the layout ``voc_eval`` reads back."""
        os.makedirs(det_dir, exist_ok=True)
        template = os.path.join(det_dir, '{:s}.txt')
        for cls_idx, cls in enumerate(self._classes):
            lines = []
            for im_idx, index in enumerate(self._image_idx):
                for det in all_boxes[cls_idx][im_idx]:
                    corners = ' '.join(
                        '{:.1f}'.format(float(v) + 1.0) for v in det[:4])
                    lines.append('{} {:.3f} {}\n'.format(
                        index, det[-1], corners))
            with open(template.format(cls), 'wt') as f:
                f.writelines(lines)
        return template

    def evaluate_detections(self, eval_dir, global_step, all_boxes):
        """Write per-class det files and score every class's AP."""
        det_dir = os.path.join(
            eval_dir, 'detection_files_{}'.format(global_step))
        det_template = self._write_class_det_files(det_dir, all_boxes)

        voc_dir = os.path.join(self._data_root_path, 'VOC' + self._year)
        anno_template = os.path.join(voc_dir, 'Annotations', '{:s}.xml')
        split_file = os.path.join(voc_dir, 'ImageSets', 'Main',
                                  self._image_set + '.txt')
        cache_dir = os.path.join(self._data_root_path, 'annotations_cache')
        use_07_metric = int(self._year) < 2010
        aps = []
        for cls in self._classes:
            _, _, ap = voc_eval.voc_eval(
                det_template, anno_template, split_file, cls, cache_dir,
                ovthresh=0.5, use_07_metric=use_07_metric)
            aps.append(ap)
            print('{}: AP = {:.4f}'.format(cls, ap))
        print('Mean AP = {:.4f}'.format(np.mean(aps)))
        return aps, list(self._classes)
