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
    kitti_squeezedet_config,
    scale_recipe_to_batch,
    tiny_test_config,
)
from squeezedet_torch.config.voc import (  # noqa: F401
    config_for_dataset,
    voc_config_for_net,
)

_CONFIG_FACTORIES = {"squeezeDet": kitti_squeezedet_config}


def require_ported(net: str) -> None:
    """Raise NotImplementedError for a net the JAX package supports but
    this port does not yet."""
    if net in ("squeezeDet+", "vgg16", "resnet50"):
        raise NotImplementedError(
            "{} is not ported yet: it arrives with the other backbones "
            "(ROADMAP Queue 1 item 11)".format(net))


def config_for_net(net: str) -> ModelConfig:
    """Look up the KITTI config factory for a net name."""
    require_ported(net)
    if net not in _CONFIG_FACTORIES:
        raise ValueError(
            "Selected neural net architecture not supported: {}".format(net))
    return _CONFIG_FACTORIES[net]()
