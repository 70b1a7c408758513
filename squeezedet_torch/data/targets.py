"""Dense training targets from the host matcher's sparse assignments
(counterpart of ``squeezedet_tpu/data/targets.py``).

Per image, each GT box's anchor gets its mask, deltas, box and one-hot
label; a later box whose anchor an earlier box of the same image already
claimed is dropped (first claim wins), as the reference does.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from squeezedet_torch.models.skeleton import Targets


def dense_targets_from_batch(
        label_per_batch: List[List[int]],
        delta_per_batch: List[List[List[float]]],
        aidx_per_batch: List[List[int]],
        bbox_per_batch: List[np.ndarray],
        *, num_anchors: int, num_classes: int,
        return_num_discarded: bool = False):
    """Dense [B, A] mask, [B, A, 4] deltas and boxes, [B, A, C] labels,
    as CPU f32 tensors."""
    batch = len(label_per_batch)
    input_mask = np.zeros((batch, num_anchors), np.float32)
    box_delta = np.zeros((batch, num_anchors, 4), np.float32)
    box_input = np.zeros((batch, num_anchors, 4), np.float32)
    labels = np.zeros((batch, num_anchors, num_classes), np.float32)

    num_discarded = 0
    claimed = set()
    for i in range(batch):
        for j in range(len(label_per_batch[i])):
            aidx = aidx_per_batch[i][j]
            if (i, aidx) in claimed:
                num_discarded += 1
                continue
            claimed.add((i, aidx))
            input_mask[i, aidx] = 1.0
            box_delta[i, aidx] = delta_per_batch[i][j]
            box_input[i, aidx] = bbox_per_batch[i][j]
            labels[i, aidx, int(label_per_batch[i][j])] = 1.0

    tg = Targets(*(torch.from_numpy(a) for a in (input_mask, box_delta,
                                                 box_input, labels)))
    if return_num_discarded:
        return tg, num_discarded
    return tg


def batch_to_dense_targets(batch_tuple, *, num_anchors: int,
                           num_classes: int) -> Tuple[np.ndarray, Targets]:
    """(``Imdb.read_batch`` output) -> (images [B, H, W, 3] f32, Targets)."""
    (image_per_batch, label_per_batch, delta_per_batch, aidx_per_batch,
     bbox_per_batch) = batch_tuple
    images = np.stack(image_per_batch).astype(np.float32)
    targets = dense_targets_from_batch(
        label_per_batch, delta_per_batch, aidx_per_batch, bbox_per_batch,
        num_anchors=num_anchors, num_classes=num_classes)
    return images, targets
