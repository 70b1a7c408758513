"""Box geometry primitives on tensors (counterpart of
``squeezedet_tpu/ops/boxes.py``)."""

from __future__ import annotations

import numpy as np
import torch


def batch_iou(boxes: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """IoU of center-format boxes [N, 4] against one box [4] -> [N].

    A batch of boxes [B, 4] gives [B, N], one row per box.  No epsilon,
    as in the JAX function: two zero-area boxes divide by zero.
    """
    bx, by = box[..., None, 0], box[..., None, 1]
    bw, bh = box[..., None, 2], box[..., None, 3]
    lr = (torch.minimum(boxes[:, 0] + 0.5 * boxes[:, 2], bx + 0.5 * bw) -
          torch.maximum(boxes[:, 0] - 0.5 * boxes[:, 2], bx - 0.5 * bw)
          ).clamp(min=0)
    tb = (torch.minimum(boxes[:, 1] + 0.5 * boxes[:, 3], by + 0.5 * bh) -
          torch.maximum(boxes[:, 1] - 0.5 * boxes[:, 3], by - 0.5 * bh)
          ).clamp(min=0)
    inter = lr * tb
    union = boxes[:, 2] * boxes[:, 3] + bw * bh - inter
    return inter / union


def pairwise_iou_center(a: torch.Tensor, b: torch.Tensor,
                        eps: float = 0.0) -> torch.Tensor:
    """IoU matrix [..., N, M] between center-format box sets [..., N, 4]
    and [..., M, 4].  ``eps`` guards the division for padded zero boxes
    (pass 0 to match the reference host path on non-degenerate data)."""
    ax1, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax2, ay2 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx1, by1 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx2, by2 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    lr = (torch.minimum(ax2[..., :, None], bx2[..., None, :]) -
          torch.maximum(ax1[..., :, None], bx1[..., None, :])).clamp(min=0)
    tb = (torch.minimum(ay2[..., :, None], by2[..., None, :]) -
          torch.maximum(ay1[..., :, None], by1[..., None, :])).clamp(min=0)
    inter = lr * tb
    union = ((a[..., 2] * a[..., 3])[..., :, None]
             + (b[..., 2] * b[..., 3])[..., None, :] - inter)
    return inter / (union + eps)


def safe_exp(w: torch.Tensor, thresh: float) -> torch.Tensor:
    """exp below ``thresh``, linearised above.

    The exp input is zeroed in the linear region before exponentiating,
    as the reference does, so neither the value nor a gradient ever sees
    exp of a large number.
    """
    slope = float(np.exp(thresh))
    lin = w > thresh
    lin_out = slope * (w - thresh + 1.0)
    exp_out = torch.exp(torch.where(lin, torch.zeros_like(w), w))
    return torch.where(lin, lin_out, exp_out)
