"""Configuration layer: frozen dataclasses + precomputed anchor grids."""

from squeezedet_torch.config.anchors import (  # noqa: F401
    RESNET50_ANCHOR_SHAPES,
    SQUEEZEDET_ANCHOR_SHAPES,
    make_anchor_grid,
)
from squeezedet_torch.config.base import (  # noqa: F401
    KITTI_CLASS_NAMES,
    PASCAL_VOC_CLASS_NAMES,
    VGG_BGR_MEANS,
    ModelConfig,
    base_model_config,
)
from squeezedet_torch.config.kitti import (  # noqa: F401
    config_for_net_at,
    custom_kitti_config,
    grid_for_net,
    kitti_model_config,
    kitti_res50_config,
    kitti_squeezedet_config,
    kitti_squeezedet_plus_config,
    kitti_vgg16_config,
    scale_recipe_to_batch,
    tiny_test_config,
)
from squeezedet_torch.config.voc import (  # noqa: F401
    config_for_dataset,
    voc_config_for_net,
)

_CONFIG_FACTORIES = {
    "squeezeDet": kitti_squeezedet_config,
    "squeezeDet+": kitti_squeezedet_plus_config,
    "vgg16": kitti_vgg16_config,
    "resnet50": kitti_res50_config,
}


def config_for_net(net: str) -> ModelConfig:
    """Look up the KITTI config factory for a net name."""
    if net not in _CONFIG_FACTORIES:
        raise ValueError(
            "Selected neural net architecture not supported: {}".format(net))
    return _CONFIG_FACTORIES[net]()
