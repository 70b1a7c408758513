"""A synthetic KITTI tree written with the port's PNG codec, for smoke
runs, profiles and the learning-parity recipe of the train CLI on a host
without OpenCV.

Each frame is dark noise with 1-3 filled, class-coloured boxes and their
KITTI label lines, as ``tests/synth_kitti.py`` draws them: the class
decides a box's colour and shape, so classification is learnable.
:func:`make_synth_kitti` is that generator (same draws from the seed,
same pixels, same label lines); :func:`write_kitti_fixture` scales the
boxes to the frame height.  Rows are written with libpng's adaptive filter choice by
default (``png.encode_png(filter_type=None)``), the row-filter mix of a
file that libpng writes with its defaults.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from squeezedet_torch.data import png

CLASSES = ("Car", "Pedestrian", "Cyclist")
_BGR = {"Car": (200, 60, 40), "Pedestrian": (40, 200, 60),
        "Cyclist": (40, 60, 200)}


def make_synth_kitti(root: str, num_images: int = 6, width: int = 320,
                     height: int = 96, seed: int = 0, image_set: str = "train",
                     start_index: int = 0) -> List[str]:
    """``tests/synth_kitti.py``'s fixture: ``num_images`` frames numbered
    from ``start_index`` with 1-3 boxes of unscaled sizes each, drawn
    from ``np.random.RandomState(seed)`` in its order (a filled
    rectangle covers both corners, as ``cv2.rectangle(..., -1)`` fills
    it); returns the image indices.  Rows are written unfiltered, which
    encodes about 2.5x faster than the adaptive choice; the pixels are
    the same."""
    return write_kitti_fixture(root, num_images, (height, width), seed=seed,
                               filter_type=0, image_set=image_set,
                               start_index=start_index, scale=1)


def write_kitti_fixture(root: str, n: int, frame: Tuple[int, int],
                        seed: int = 0,
                        filter_type: Optional[int] = None,
                        image_set: str = "train",
                        boxes: Tuple[int, int] = (1, 4),
                        start_index: int = 0,
                        scale: Optional[int] = None) -> List[str]:
    """Write ``n`` frames of [H, W] = ``frame`` and their labels under
    ``root`` (``training/image_2``, ``training/label_2``,
    ``ImageSets/<image_set>.txt``), with ``boxes[0]`` to ``boxes[1] - 1``
    boxes a frame, their sizes times ``scale`` (default ``H // 96``);
    returns the image indices."""
    rng = np.random.RandomState(seed)
    height, width = frame
    s = max(1, height // 96) if scale is None else scale
    img_dir = os.path.join(root, "training", "image_2")
    lbl_dir = os.path.join(root, "training", "label_2")
    for d in (img_dir, lbl_dir, os.path.join(root, "ImageSets")):
        os.makedirs(d, exist_ok=True)
    indices = []
    for i in range(start_index, start_index + n):
        idx = "{:06d}".format(i)
        indices.append(idx)
        im = rng.randint(0, 60, (height, width, 3)).astype(np.uint8)
        lines = []
        for _ in range(rng.randint(*boxes)):
            cls = CLASSES[rng.randint(len(CLASSES))]
            hmax = min(80 * s, height - 4)
            if cls == "Car":
                h = rng.randint(42 * s, min(60 * s, hmax))
                w = rng.randint(70 * s, 95 * s)
            elif cls == "Pedestrian":
                h = rng.randint(60 * s, hmax + 1)
                w = rng.randint(25 * s, 40 * s)
            else:
                h = rng.randint(45 * s, min(70 * s, hmax))
                w = h + rng.randint(-4 * s, 4 * s + 1)
            x1 = rng.randint(0, width - w - 1)
            y1 = rng.randint(0, height - h - 1)
            im[y1:y1 + h + 1, x1:x1 + w + 1] = [
                np.clip(c + rng.randint(-30, 30), 0, 255) for c in _BGR[cls]]
            lines.append("{} 0.00 0 0.0 {:.2f} {:.2f} {:.2f} {:.2f} 1.5 1.6 "
                         "3.7 0.0 1.7 10.0 0.0".format(cls, x1, y1, x1 + w,
                                                       y1 + h))
        png.write_png(os.path.join(img_dir, idx + ".png"), im, level=1,
                      filter_type=filter_type)
        with open(os.path.join(lbl_dir, idx + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "ImageSets", image_set + ".txt"),
              "w") as f:
        f.write("\n".join(indices) + "\n")
    return indices
