"""KITTI configurations (counterpart of ``squeezedet_tpu/config/kitti.py``).

The four backbones' factories (squeezeDet, squeezeDet+, vgg16,
resnet50) and the legacy generic one, the grid arithmetic, custom
resolutions and the tiny test config.  All share one training recipe;
they differ in input resolution, batch size, detection grid and anchor
shapes.
"""

from __future__ import annotations

import numpy as np

from .anchors import (RESNET50_ANCHOR_SHAPES, SQUEEZEDET_ANCHOR_SHAPES,
                      make_anchor_grid)
from .base import ModelConfig, base_model_config

# Shared KITTI training recipe (kitti_squeezeDet_config.py:17-37).
_KITTI_COMMON = dict(
    weight_decay=1e-4,
    learning_rate=0.01,
    decay_steps=10000,
    max_grad_norm=1.0,
    momentum=0.9,
    lr_decay_factor=0.5,
    loss_coef_bbox=5.0,
    loss_coef_conf_pos=75.0,
    loss_coef_conf_neg=100.0,
    loss_coef_class=1.0,
    plot_prob_thresh=0.4,
    nms_thresh=0.4,
    prob_thresh=0.005,
    top_n_detection=64,
    data_augmentation=True,
    drift_x=150,
    drift_y=100,
    exclude_hard_examples=False,
    anchor_per_grid=9,
)


def _kitti_config(net: str, image_width: int, image_height: int, grid_w: int,
                  grid_h: int, shapes: np.ndarray,
                  batch_size: int = 20) -> ModelConfig:
    base = base_model_config("KITTI")
    anchors = make_anchor_grid(image_width, image_height, grid_w, grid_h,
                               shapes)
    return base.replace(net=net, image_width=image_width,
                        image_height=image_height, batch_size=batch_size,
                        grid_w=grid_w, grid_h=grid_h, anchor_box=anchors,
                        **_KITTI_COMMON)


def kitti_squeezedet_config() -> ModelConfig:
    """1248x384 input, 24x78x9 = 16,848 anchors (kitti_squeezeDet_config.py)."""
    return _kitti_config("squeezeDet", 1248, 384, 78, 24,
                         SQUEEZEDET_ANCHOR_SHAPES)


def kitti_squeezedet_plus_config() -> ModelConfig:
    """1242x375 input, 22x76x9 = 15,048 anchors
    (kitti_squeezeDetPlus_config.py)."""
    return _kitti_config("squeezeDet+", 1242, 375, 76, 22,
                         SQUEEZEDET_ANCHOR_SHAPES)


def kitti_vgg16_config() -> ModelConfig:
    """1242x375 input, batch 5, 24x78x9 anchors (kitti_vgg16_config.py)."""
    return _kitti_config("vgg16", 1242, 375, 78, 24,
                         SQUEEZEDET_ANCHOR_SHAPES, batch_size=5)


def kitti_res50_config() -> ModelConfig:
    """1242x375 input, 24x78x9 anchors with the ResNet shape table
    (kitti_res50_config.py)."""
    return _kitti_config("resnet50", 1242, 375, 78, 24,
                         RESNET50_ANCHOR_SHAPES)


def kitti_model_config() -> ModelConfig:
    """Legacy generic variant (kitti_model_config.py): 1248x384, 24x78x9."""
    return _kitti_config("model", 1248, 384, 78, 24, SQUEEZEDET_ANCHOR_SHAPES)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_for_net(net: str, size: int) -> int:
    """Detection-grid extent along one image dimension for a backbone
    (each backbone's stride-16 downsampling arithmetic)."""
    if net in ("squeezeDet", "model"):
        return _cdiv(_cdiv(_cdiv(_cdiv(size, 2), 2), 2), 2)
    if net == "squeezeDet+":
        s = _cdiv(size - 6, 2)          # conv1 7x7 s2 VALID
        for _ in range(3):              # pool1, pool4, pool8: 3x3 s2 VALID
            s = _cdiv(s - 2, 2)
        return s
    if net == "vgg16":
        for _ in range(4):
            size = _cdiv(size, 2)
        return size
    if net == "resnet50":
        s = _cdiv(size, 2)              # conv1 s2 SAME
        s = _cdiv(s - 2, 2)             # pool1 3x3 s2 VALID
        s = _cdiv(s, 2)                 # res3a s2
        return _cdiv(s, 2)              # res4a s2
    raise ValueError("unknown net %r" % net)


def custom_kitti_config(net: str, image_width: int, image_height: int,
                        batch_size: int = 20) -> ModelConfig:
    """KITTI config at a non-standard resolution: the anchor grid follows
    the backbone's downsampling and the shape table scales with the
    resolution (the canonical tables assume ~1248x384)."""
    shapes = (RESNET50_ANCHOR_SHAPES if net == "resnet50"
              else SQUEEZEDET_ANCHOR_SHAPES)
    shapes = shapes * np.array([[image_width / 1248.0,
                                 image_height / 384.0]])
    cfg = _kitti_config(net, image_width, image_height,
                        grid_for_net(net, image_width),
                        grid_for_net(net, image_height),
                        shapes, batch_size=batch_size)
    return cfg.replace(
        drift_x=max(1, round(150 * image_width / 1248.0)),
        drift_y=max(1, round(100 * image_height / 384.0)))


def config_for_net_at(net: str, image_width: int = 0,
                      image_height: int = 0) -> ModelConfig:
    """Net config at its canonical resolution, or a custom one when
    either override is non-zero."""
    from squeezedet_torch.config import config_for_net
    base = config_for_net(net)
    if not (image_width or image_height):
        return base
    return custom_kitti_config(net, image_width or base.image_width,
                               image_height or base.image_height)


def scale_recipe_to_batch(cfg: ModelConfig, batch_size: int,
                          warmup_frac: float = 0.1,
                          total_steps: int = 0) -> ModelConfig:
    """Rescale a config's training recipe, taken as tuned at
    ``cfg.batch_size``, to another batch size: the learning rate and
    ``loss_coef_conf_pos`` scale linearly (the conf loss makes the
    positive-confidence weight ~1/batch), ``decay_steps`` inversely (the
    decay fires at the same sample count), and ``lr_warmup_steps`` is
    ``warmup_frac * total_steps`` when ``total_steps`` is given."""
    r = batch_size / cfg.batch_size
    return cfg.replace(
        batch_size=batch_size,
        learning_rate=cfg.learning_rate * r,
        decay_steps=max(1, int(round(cfg.decay_steps / r))),
        loss_coef_conf_pos=cfg.loss_coef_conf_pos * r,
        lr_warmup_steps=(int(round(warmup_frac * total_steps))
                         if total_steps else cfg.lr_warmup_steps),
    )


def tiny_test_config(net: str = "squeezeDet", image_width: int = 96,
                     image_height: int = 96,
                     batch_size: int = 2) -> ModelConfig:
    """Small hermetic config for unit tests: the exact structure (9
    anchors/cell, same recipe) at a size that runs in milliseconds."""
    grid_w = grid_for_net(net, image_width)
    grid_h = grid_for_net(net, image_height)
    shapes = SQUEEZEDET_ANCHOR_SHAPES / 8.0
    cfg = _kitti_config(net, image_width, image_height, grid_w, grid_h,
                        shapes, batch_size=batch_size)
    return cfg.replace(load_pretrained_model=False)
