"""Host utilities (counterpart of ``squeezedet_tpu/utils/util.py``):
box format conversions, box drawing, channel flips, the entry points'
device check and a tic/toc timer."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def bbox_transform(bbox):
    """Center (cx, cy, w, h) -> corners (xmin, ymin, xmax, ymax), with no
    pixel offset."""
    cx, cy, w, h = bbox
    return [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]


def bbox_transform_inv(bbox):
    """Corners (xmin, ymin, xmax, ymax) -> center (cx, cy, w, h), with the
    reference's +1 convention: a box over pixel columns xmin..xmax is
    xmax - xmin + 1 wide."""
    xmin, ymin, xmax, ymax = bbox
    width = xmax - xmin + 1.0
    height = ymax - ymin + 1.0
    return [xmin + 0.5 * width, ymin + 0.5 * height, width, height]


def bgr_to_rgb(ims):
    """Flip the channels of a list of BGR images."""
    return [im[:, :, ::-1] for im in ims]


def resolve_device(name: str, what: str):
    """``torch.device(name)`` for an entry point; exits when CUDA is asked
    for and missing, so ``what`` never carries on on the CPU unless asked
    to."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device {} but torch sees no CUDA device; {} "
                         "does not fall back to the CPU".format(name, what))
    return device


class Timer:
    """tic/toc timer with a running average."""

    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.duration = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average: bool = True):
        self.duration = time.time() - self.start_time
        self.total_time += self.duration
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.duration


def draw_box(im: np.ndarray, box_list, label_list, color=(0, 255, 0),
             cdict: Optional[dict] = None, form: str = 'center'):
    """Draw labelled boxes on ``im`` in place, with OpenCV (imported
    here, so only callers that draw need it)."""
    import cv2
    assert form in ('center', 'diagonal'), \
        'bounding box format not accepted: {}.'.format(form)
    for bbox, label in zip(box_list, label_list):
        if form == 'center':
            bbox = bbox_transform(bbox)
        xmin, ymin, xmax, ymax = [int(b) for b in bbox]
        l = label.split(':')[0]  # noqa: E741
        c = cdict[l] if cdict and l in cdict else color
        cv2.rectangle(im, (xmin, ymin), (xmax, ymax), c, 1)
        cv2.putText(im, label, (xmin, ymax), cv2.FONT_HERSHEY_SIMPLEX,
                    0.3, c, 1)
