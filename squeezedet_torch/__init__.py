"""PyTorch / CUDA port of the SqueezeDet detection framework.

A second package beside ``squeezedet_tpu`` (the JAX reference it is
held against), written for one NVIDIA H100.  It imports torch and
numpy only: never jax, and nothing from ``squeezedet_tpu``.

This slice covers the uint8 -> detections serving path of the
squeezeDet backbone: mean subtraction, the backbone with conv1+pool1
in a hand-written CUDA kernel (``ops/fused_frontend.py``), the ConvDet
head, interpretation, and top-K + per-class NMS.  Every constructor
and entry point takes an explicit ``device``.
"""

from squeezedet_torch.config import (  # noqa: F401
    ModelConfig,
    base_model_config,
    config_for_net,
    kitti_squeezedet_config,
    tiny_test_config,
)
from squeezedet_torch.models import Detector, get_model  # noqa: F401

__version__ = "0.1.0"
