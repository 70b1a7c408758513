"""On-device preprocessing (counterpart of ``normalize_images`` in
``squeezedet_tpu/data/device_pipeline.py``)."""

from __future__ import annotations

import torch


def normalize_images(images_u8: torch.Tensor, bgr_means,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 BGR [B, H, W, 3] -> mean-subtracted tensor in ``dtype``.

    Device-side ``im.astype(float32) - BGR_MEANS``: the cast and the
    subtraction both happen in ``dtype``, as in the JAX package, so only
    the 1-byte image crosses to the device.
    """
    means = torch.tensor(bgr_means, dtype=dtype,
                         device=images_u8.device).view(1, 1, 1, 3)
    return images_u8.to(dtype) - means
