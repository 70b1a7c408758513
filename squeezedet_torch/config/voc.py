"""Pascal VOC model configurations (counterpart of
``squeezedet_tpu/config/voc.py``).

A VOC config is the net's KITTI geometry and training recipe with the 20
VOC classes swapped in; the ConvDet head width follows ``cfg.classes``.
"""

from __future__ import annotations

from .base import PASCAL_VOC_CLASS_NAMES, ModelConfig
from .kitti import config_for_net_at


def voc_config_for_net(net: str, image_width: int = 0,
                       image_height: int = 0) -> ModelConfig:
    """VOC config for a backbone, optionally at a custom resolution.

    Defaults to the net's canonical KITTI resolution; VOC photographs
    are closer to 500x375, so passing an override (e.g. 512x384) is
    usually what you want.
    """
    cfg = config_for_net_at(net, image_width, image_height)
    return cfg.replace(dataset="PASCAL_VOC",
                       class_names=PASCAL_VOC_CLASS_NAMES)


def config_for_dataset(dataset: str, net: str, image_width: int = 0,
                       image_height: int = 0) -> ModelConfig:
    """Config dispatch shared by the train/eval CLIs: ``dataset`` is
    ``KITTI`` or ``VOC``/``PASCAL_VOC`` (the CLI-flag spellings)."""
    if dataset == "KITTI":
        return config_for_net_at(net, image_width, image_height)
    if dataset in ("VOC", "PASCAL_VOC"):
        return voc_config_for_net(net, image_width, image_height)
    raise ValueError("unknown dataset {!r}: KITTI or VOC".format(dataset))
