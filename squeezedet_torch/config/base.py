"""Model configuration (counterpart of ``squeezedet_tpu/config/base.py``).

An immutable dataclass with the same fields and defaults as the JAX
package's, so one config describes a model in both packages; entry
points derive modified copies with :meth:`ModelConfig.replace`.  Anchor
boxes are config data: a numpy array that the model turns into a device
tensor.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

# BGR channel means subtracted from inputs (VGG16 means).
VGG_BGR_MEANS = (103.939, 116.779, 123.68)

KITTI_CLASS_NAMES = ("car", "pedestrian", "cyclist")
PASCAL_VOC_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog",
    "horse", "motorbike", "person", "pottedplant", "sheep",
    "sofa", "train", "tvmonitor",
)


@dataclass(frozen=True)
class ModelConfig:
    """All model/training hyperparameters, field for field the JAX
    package's ``ModelConfig``."""

    # Dataset / classes --------------------------------------------------
    dataset: str = "KITTI"
    class_names: Tuple[str, ...] = KITTI_CLASS_NAMES

    # Geometry ------------------------------------------------------------
    image_width: int = 224
    image_height: int = 224
    # Anchor boxes: float array [num_anchors, 4] of (cx, cy, w, h) in pixels.
    anchor_box: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.float64), repr=False)
    anchor_per_grid: int = -1
    # Detection-head grid (anchors = grid_h * grid_w * anchor_per_grid).
    grid_h: int = 0
    grid_w: int = 0

    # Batch / thresholds ---------------------------------------------------
    batch_size: int = 20
    prob_thresh: float = 0.005
    plot_prob_thresh: float = 0.5
    nms_thresh: float = 0.2
    top_n_detection: int = 64

    # Input normalisation ---------------------------------------------------
    bgr_means: Tuple[float, float, float] = VGG_BGR_MEANS

    # Legacy fields kept for field-for-field parity.
    grid_pool_width: int = 7
    grid_pool_height: int = 7
    loss_coef_conf: float = 1.0

    # Loss coefficients -----------------------------------------------------
    loss_coef_conf_pos: float = 1.0
    loss_coef_conf_neg: float = 1.0
    loss_coef_class: float = 1.0
    loss_coef_bbox: float = 10.0

    # Optimisation ----------------------------------------------------------
    learning_rate: float = 0.005
    decay_steps: int = 10000
    lr_decay_factor: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0005
    max_grad_norm: float = 10.0
    lr_warmup_steps: int = 0

    # Dropout / misc ----------------------------------------------------------
    keep_prob: float = 0.5
    leaky_coef: float = 0.1
    epsilon: float = 1e-16
    exp_thresh: float = 1.0
    batch_norm_epsilon: float = 1e-5

    # Pretrained weights ------------------------------------------------------
    load_pretrained_model: bool = True
    pretrained_model_path: str = ""

    # Data augmentation ---------------------------------------------------------
    data_augmentation: bool = False
    drift_x: int = 0
    drift_y: int = 0
    exclude_hard_examples: bool = True

    # Runtime -------------------------------------------------------------------
    is_training: bool = False
    debug_mode: bool = False
    num_thread: int = 4
    queue_capacity: int = 100
    image_cache_mb: int = 0

    # Accelerator knobs ---------------------------------------------------------
    # Compute dtype for conv paths ("float32" or "bfloat16"); params stay f32.
    compute_dtype: str = "float32"
    # Weight init when no pretrained model is loaded: "xavier" keeps the
    # signal alive through the fire chain from scratch; "reference" uses
    # the original truncated-normal fallbacks.  The ConvDet head keeps its
    # 1e-4 stddev in both modes.
    scratch_init: str = "xavier"
    use_native_loader: bool = False
    # Name of the model family this config was built for ("squeezeDet", ...).
    net: str = ""

    # ----------------------------------------------------------------------
    @property
    def classes(self) -> int:
        return len(self.class_names)

    @property
    def anchors(self) -> int:
        return int(len(self.anchor_box))

    @property
    def head_channels(self) -> int:
        """ConvDet output channels: B*(C + 1 + 4)."""
        return self.anchor_per_grid * (self.classes + 1 + 4)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def bgr_means_array(self) -> np.ndarray:
        return np.array(self.bgr_means, np.float32).reshape(1, 1, 3)


def base_model_config(dataset: str = "PASCAL_VOC") -> ModelConfig:
    """Base config matching the reference ``base_model_config`` defaults."""
    dataset = dataset.upper()
    if dataset == "PASCAL_VOC":
        names = PASCAL_VOC_CLASS_NAMES
    elif dataset == "KITTI":
        names = KITTI_CLASS_NAMES
    else:
        raise ValueError(
            "Currently only support PASCAL_VOC or KITTI dataset, got %r" % dataset)
    return ModelConfig(dataset=dataset, class_names=names)
