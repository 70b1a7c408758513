"""On-device preprocessing and anchor-target assignment (counterpart of
``squeezedet_tpu/data/device_pipeline.py``).

Ground truth arrives padded to G boxes per image with a validity count,
so every shape is static: the matcher runs sequentially over the G slots
and batched over the images, on the images' device.  Nothing here copies
from the host (:func:`bgr_means_tensor`), so a train step captured in a
CUDA graph runs all of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from squeezedet_torch.models.skeleton import Targets
from squeezedet_torch.ops.anchor_match import anchor_match
from squeezedet_torch.ops.boxes import batch_iou
from squeezedet_torch.utils.profiling import span


def bgr_means_tensor(bgr_means, device, dtype: torch.dtype) -> torch.Tensor:
    """``bgr_means`` as a [1, 1, 1, 3] tensor on ``device`` in ``dtype``,
    each channel filled on the device: no host-to-device copy, which a
    stream capture would refuse (``torch.tensor`` of a list makes one)."""
    means = torch.empty((1, 1, 1, 3), dtype=dtype, device=device)
    for c, m in enumerate(bgr_means):
        means[..., c].fill_(float(m))
    return means


def normalize_images(images_u8: torch.Tensor, bgr_means,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 BGR [B, H, W, 3] -> mean-subtracted tensor in ``dtype``.

    Device-side ``im.astype(float32) - BGR_MEANS``: the cast and the
    subtraction both happen in ``dtype``, as in the JAX package, so only
    the 1-byte image crosses to the device.
    """
    return images_u8.to(dtype) - bgr_means_tensor(bgr_means,
                                                  images_u8.device, dtype)


def resize_images(images: torch.Tensor, height: int,
                  width: int) -> torch.Tensor:
    """Batched bilinear resize on the images' device (serving path):
    NHWC uint8 or float -> NHWC f32 [B, height, width, C].

    Computes ``jax.image.resize(..., method="linear", antialias=False)``:
    the half-pixel convention, two taps an output pixel and no
    antialiasing when it downsamples; at the edges JAX drops the tap
    outside the image and renormalises the other to 1, which is the
    clamp of ``F.interpolate``'s bilinear mode without
    ``align_corners``.  The two round the sample positions ``(o + 0.5) *
    in / out - 0.5`` in f32 in other orders (so do XLA's fused program
    and the CUDA kernel), which moves a sample by an ulp of the input's
    extent and its pixel by that times the step to its neighbour.
    """
    x = images.float().permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).contiguous()


def _resample_weights(out_n: int, src_n: int, extent: torch.Tensor,
                      off: torch.Tensor, flip=None) -> torch.Tensor:
    """Per-image bilinear weights [B, out_n, src_n] of cv2.resize's sample
    positions in post-drift space, clamped at the shifted-canvas border
    (border replicate) and optionally mirrored; a sample left of the
    image (negative drift) matches no column and so reads 0."""
    o = torch.arange(out_n, dtype=torch.float32, device=extent.device)
    s = (o[None] + 0.5) * extent[:, None] / out_n - 0.5
    s = torch.minimum(torch.clamp(s, min=0.0), extent[:, None] - 1.0)
    if flip is not None:
        s = torch.where(flip[:, None] > 0, extent[:, None] - 1.0 - s, s)
    src = s + off[:, None]
    cols = torch.arange(src_n, dtype=torch.float32, device=extent.device)
    return torch.clamp(1.0 - torch.abs(src[:, :, None] - cols[None, None]),
                       min=0.0)


def augment_resize_normalize(canvas_u8: torch.Tensor, aug: torch.Tensor,
                             height: int, width: int, bgr_means,
                             dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Drift crop + horizontal flip + bilinear resize + mean subtraction
    of a uint8 canvas batch, as two batched contractions
    ``out = Wy[b] @ (canvas[b] - mean) @ Wx[b]^T`` in f32.

    ``canvas_u8`` [B, H0, W0, 3] holds each image in its top-left corner;
    ``aug`` [B, 5] f32 rows are (dx, dy, flip, ow', oh'): the drift, the
    flip flag and the post-drift extents, so the real extents are
    (ow' + dx, oh' + dy).  Canvas beyond them is masked to 0 so padding
    never leaks through clamped samples.  Returns [B, height, width, 3]
    in ``dtype``.
    """
    _, h0, w0, _ = canvas_u8.shape
    aug = aug.float()
    dx, dy, flip = aug[:, 0], aug[:, 1], aug[:, 2]
    ow, oh = aug[:, 3], aug[:, 4]
    wy = _resample_weights(height, h0, oh, dy)
    wx = _resample_weights(width, w0, ow, dx, flip)

    dev = canvas_u8.device
    x = canvas_u8.float() - bgr_means_tensor(bgr_means, dev, torch.float32)
    ymask = torch.arange(h0, device=dev)[None] < (oh + dy)[:, None]
    xmask = torch.arange(w0, device=dev)[None] < (ow + dx)[:, None]
    x = x * ymask[:, :, None, None] * xmask[:, None, :, None]
    out = torch.einsum("bhH,bHWc->bhWc", wy, x)
    out = torch.einsum("bwW,bhWc->bhwc", wx, out)
    return out.to(dtype)


def assign_anchors_device(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_labels: torch.Tensor, num_gt: torch.Tensor,
                          num_classes: int) -> Targets:
    """Greedy anchor assignment -> dense Targets, batched over images.

    Per GT slot in order: the highest-IoU unclaimed anchor with positive
    IoU (the largest index on ties), else the nearest unclaimed anchor by
    squared distance in (cx, cy, w, h) (the smallest index on ties).
    Deltas are (dx, dy, log dw, log dh).  Slots >= num_gt claim nothing
    and scatter to a dummy row that is dropped.

    Args: anchors [A, 4]; gt_boxes [B, G, 4] center format; gt_labels
    [B, G] int; num_gt [B].

    On CUDA anchors this is one launch of K3 (``ops/anchor_match.py``),
    which takes float32 boxes and int32 or int64 labels and counts, all
    on the anchors' device, or raises; on CPU anchors it is the plain
    version, :func:`assign_anchors_reference`.
    """
    if anchors.device.type == "cuda":
        return anchor_match(anchors, gt_boxes, gt_labels, num_gt,
                            num_classes)
    if anchors.device.type != "cpu":
        raise ValueError("the matcher runs on cpu or cuda tensors, got "
                         "{}".format(anchors.device))
    return assign_anchors_reference(anchors, gt_boxes, gt_labels, num_gt,
                                    num_classes)


def assign_anchors_reference(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                             gt_labels: torch.Tensor, num_gt: torch.Tensor,
                             num_classes: int) -> Targets:
    """The plain version of :func:`assign_anchors_device`: a loop of torch
    ops over the G slots, each op over [B, A], then a scatter of the
    chosen rows into zeroed targets (on any device)."""
    b, g = gt_labels.shape
    a = anchors.shape[0]
    dev = anchors.device
    rows = torch.arange(b, device=dev)
    valid = torch.arange(g, device=dev)[None] < num_gt.to(dev)[:, None]
    claimed = torch.zeros((b, a), dtype=torch.bool, device=dev)
    aidx, deltas = [], []
    for slot in range(g):
        box = gt_boxes[:, slot]
        masked_iou = torch.where(claimed, -1.0, batch_iou(anchors, box))
        best_iou = (a - 1) - torch.argmax(masked_iou.flip(1), dim=1)
        use_iou = masked_iou[rows, best_iou] > 0
        dist = torch.sum(torch.square(box[:, None] - anchors[None]), dim=2)
        best_dist = torch.argmin(torch.where(claimed, torch.inf, dist), dim=1)
        idx = torch.where(use_iou, best_iou, best_dist)
        anc = anchors[idx]
        deltas.append(torch.stack([
            (box[:, 0] - anc[:, 0]) / anc[:, 2],
            (box[:, 1] - anc[:, 1]) / anc[:, 3],
            torch.log(box[:, 2] / anc[:, 2]),
            torch.log(box[:, 3] / anc[:, 3])], dim=1))
        claimed[rows, idx] |= valid[:, slot]
        aidx.append(idx)

    safe = torch.where(valid, torch.stack(aidx, dim=1), a)  # [B, G]
    dense = rows[:, None], safe

    def scatter(values, width):
        out = torch.zeros((b, a + 1, width), device=dev)
        out[dense] = values
        return out[:, :a]

    mask = torch.zeros((b, a + 1), device=dev)
    mask[dense] = torch.ones((), device=dev)  # no host scalar: capturable
    onehot = (gt_labels.to(dev)[..., None] ==
              torch.arange(num_classes, device=dev)).float()
    return Targets(input_mask=mask[:, :a],
                   box_delta_input=scatter(torch.stack(deltas, dim=1), 4),
                   box_input=scatter(gt_boxes.float(), 4),
                   labels=scatter(onehot, num_classes))


def ingest_and_assign(det, images: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, num_gt: torch.Tensor,
                      uint8_ingest: bool, aug=None, gather=None):
    """The train-step ingest: uint8 normalisation (or, with ``aug``, the
    augment + resize program over a raw canvas batch) plus the anchor
    matcher, as the spans ``ingest`` and ``matcher``
    (``utils/profiling.span``).  ``gather``: takes ``images`` (a canvas
    dataset) to the step's canvas batch, inside the ``ingest`` span.
    Returns (images, Targets)."""
    cfg = det.cfg
    with span("ingest", images.device):
        if gather is not None:
            images = gather(images)
        if aug is not None:
            images = augment_resize_normalize(
                images, aug, cfg.image_height, cfg.image_width,
                cfg.bgr_means, det.compute_dtype)
        elif uint8_ingest:
            images = normalize_images(images, cfg.bgr_means,
                                      det.compute_dtype)
    with span("matcher", det.anchors.device):
        targets = assign_anchors_device(det.anchors, gt_boxes.float(),
                                        gt_labels, num_gt, cfg.classes)
    return images, targets
