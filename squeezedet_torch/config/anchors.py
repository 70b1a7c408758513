"""Anchor-grid generation (counterpart of ``squeezedet_tpu/config/anchors.py``).

* centers sit at fractional grid positions ``x_i = i * image_width /
  (W + 1)`` for ``i in 1..W`` (same for y): the grid is inset, not
  aligned to feature-map strides;
* the flat anchor order is row-major over (row, col, shape):
  index = (row * W + col) * B + b;
* each anchor is (cx, cy, w, h) in pixels with the per-model (w, h)
  shape table repeated at every cell.
"""

from __future__ import annotations

import numpy as np


def make_anchor_grid(image_width: int, image_height: int, grid_w: int,
                     grid_h: int, shapes: np.ndarray) -> np.ndarray:
    """Dense [grid_h * grid_w * B, 4] (cx, cy, w, h) anchors, float64."""
    shapes = np.asarray(shapes, np.float64).reshape(-1, 2)
    b = shapes.shape[0]
    cx = np.arange(1, grid_w + 1, dtype=np.float64) * float(image_width) / (grid_w + 1)
    cy = np.arange(1, grid_h + 1, dtype=np.float64) * float(image_height) / (grid_h + 1)
    cx_g = np.broadcast_to(cx[None, :, None], (grid_h, grid_w, b))
    cy_g = np.broadcast_to(cy[:, None, None], (grid_h, grid_w, b))
    w_g = np.broadcast_to(shapes[None, None, :, 0], (grid_h, grid_w, b))
    h_g = np.broadcast_to(shapes[None, None, :, 1], (grid_h, grid_w, b))
    return np.stack([cx_g, cy_g, w_g, h_g], axis=3).reshape(-1, 4)


# Fixed (w, h) anchor shape tables -------------------------------------------

# Used by squeezeDet, squeezeDet+, vgg16.
SQUEEZEDET_ANCHOR_SHAPES = np.array(
    [[36., 37.], [366., 174.], [115., 59.],
     [162., 87.], [38., 90.], [258., 173.],
     [224., 108.], [78., 170.], [72., 43.]])

# ResNet50 uses a different table.
RESNET50_ANCHOR_SHAPES = np.array(
    [[94., 49.], [225., 161.], [170., 91.],
     [390., 181.], [41., 32.], [128., 64.],
     [298., 164.], [232., 99.], [65., 42.]])
