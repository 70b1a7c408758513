"""PyTorch / CUDA port of the SqueezeDet detection framework.

A second package beside ``squeezedet_tpu`` (the JAX reference it is
held against), written for one NVIDIA H100.  It imports torch and
numpy only: never jax, and nothing from ``squeezedet_tpu``.

It covers the four backbones of the JAX package (squeezeDet,
squeezeDet+, vgg16, resnet50; ``available_nets()``) on two paths.
Serving: uint8 -> detections (mean subtraction, the backbone, whose
squeezeDet conv1+pool1 run in a hand-written CUDA kernel,
``ops/fused_frontend.py``, the ConvDet head,
interpretation, top-K + per-class NMS).  Training: the single-device
train step (``trainer.py``: on-device ingest and anchor matching, the
forward with dropout, the loss, the backward with the weight gradients
of eligible convs in a second hand-written kernel,
``ops/filter_grad.py``, and the optimizer in ``optim.py``).  The train
CLI (``train.py``), the eval daemon with KITTI and VOC scoring
(``eval.py``, ``data/kitti.py``, ``native/``), the demo (``demo.py``) and
the HTTP server (``serve.py``) drive them, on one device or data-parallel
over several (``parallel/``: one training process per device over
``torch.distributed``, one replica per device in eval and serve), or
with each image split into height x width tiles over several
(``models/halo.py``: batch-1 eval, the data x spatial train step).  Every
constructor and entry point takes an explicit ``device``.
"""

from squeezedet_torch.config import (  # noqa: F401
    ModelConfig,
    base_model_config,
    config_for_net,
    kitti_res50_config,
    kitti_squeezedet_config,
    kitti_squeezedet_plus_config,
    kitti_vgg16_config,
    tiny_test_config,
)
from squeezedet_torch.models import (  # noqa: F401
    Detector,
    available_nets,
    get_model,
)

__version__ = "0.1.0"
