"""The greedy anchor matcher in one kernel launch (K3).

:func:`anchor_match` computes ``data/device_pipeline.
assign_anchors_device`` on CUDA tensors with the hand-written kernel in
``csrc/anchor_match.cu``: one thread-block cluster an image, each CTA of
it holding a slice of the anchors (:func:`plan`), one round a valid
ground-truth slot, and the four dense targets written by the kernel
itself.  Its results equal the plain version's
(``device_pipeline.assign_anchors_reference``, which the wrapper there
runs on CPU tensors) bit for bit on the card.  K3 replaces no TPU kernel:
the JAX package's matcher is plain jnp, and the port's loop of torch ops
was two thirds of the train step's kernels (the source's note).

The call enqueues one kernel on the current stream, with no host sync
and no host scalar, so a captured train step holds it; it is
deterministic (no atomics).  Nothing falls back: a CUDA call the kernel
does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from squeezedet_torch.models.skeleton import Targets
from squeezedet_torch.ops import _cuda

# Kernel launches by :func:`anchor_match` in this process.
LAUNCHES = 0

# csrc/anchor_match.cu: threads a CTA, the portable cluster size, the
# anchors a thread a round the plan aims at, a CTA's shared memory, and
# the "no slot" value of the 16-bit claim each anchor keeps there
THREADS = 512
MAX_CLUSTER = 8
ANCHORS_PER_THREAD = 4
SMEM_LIMIT = 232448
NO_SLOT = 0xFFFF

_INDEX_DTYPES = {torch.int32: 0, torch.int64: 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


class Plan(NamedTuple):
    cluster: int  # CTAs an image: one thread-block cluster
    slice: int    # anchors a CTA (the last CTA's may be fewer), each
                  # with a 2-byte claim in the CTA's shared memory


def plan(b: int, g: int, a: int) -> Plan:
    """K3's launch plan for ``b`` images of ``g`` slots over ``a``
    anchors: the fewest CTAs an image (at most MAX_CLUSTER) that give a
    thread at most ANCHORS_PER_THREAD anchors a round, and the anchors cut
    into that many equal slices.  Raises where the kernel cannot take the
    shape."""
    if b < 1 or g < 1 or a < 1:
        raise ValueError("the matcher needs B, G and A of at least 1, got "
                         "{}, {} and {}".format(b, g, a))
    if g >= NO_SLOT:
        raise ValueError("K3 keeps a slot in 16 bits: G must be below {}, "
                         "got {}".format(NO_SLOT, g))
    cluster = min(MAX_CLUSTER, -(-a // (THREADS * ANCHORS_PER_THREAD)))
    size = -(-a // cluster)
    if 2 * size > SMEM_LIMIT:
        raise ValueError("K3 holds at most {} anchors, got {}".format(
            MAX_CLUSTER * (SMEM_LIMIT // 2), a))
    if b * cluster > 2 ** 31 - 1:
        raise ValueError("batch too large for one launch: {}".format(b))
    return Plan(cluster, size)


def check_inputs(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_labels: torch.Tensor, num_gt: torch.Tensor,
                 num_classes: int) -> None:
    """What K3 takes: float32 anchors [A, 4] and gt_boxes [B, G, 4],
    int32 or int64 gt_labels [B, G] and num_gt [B], at least one class,
    all contiguous on one device, anchors and boxes starting on a 16-byte
    boundary (the kernel reads a box as one 16-byte load)."""
    if anchors.dim() != 2 or anchors.shape[1] != 4:
        raise ValueError("anchors must be [A, 4], got {}".format(
            tuple(anchors.shape)))
    if gt_boxes.dim() != 3 or gt_boxes.shape[2] != 4 or \
            tuple(gt_labels.shape) != tuple(gt_boxes.shape[:2]) or \
            tuple(num_gt.shape) != tuple(gt_boxes.shape[:1]):
        raise ValueError("need gt_boxes [B, G, 4], gt_labels [B, G] and "
                         "num_gt [B], got {}, {} and {}".format(
                             tuple(gt_boxes.shape), tuple(gt_labels.shape),
                             tuple(num_gt.shape)))
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError("anchors and gt_boxes must be float32, got {} and "
                        "{}".format(anchors.dtype, gt_boxes.dtype))
    if gt_labels.dtype not in _INDEX_DTYPES or \
            num_gt.dtype not in _INDEX_DTYPES:
        raise TypeError("gt_labels and num_gt must be int32 or int64, got "
                        "{} and {}".format(gt_labels.dtype, num_gt.dtype))
    if num_classes < 1:
        raise ValueError("num_classes must be at least 1, got {}".format(
            num_classes))
    tensors = (anchors, gt_boxes, gt_labels, num_gt)
    if any(t.device != anchors.device for t in tensors):
        raise ValueError("anchors, gt_boxes, gt_labels and num_gt must "
                         "share a device, got {}".format(
                             [str(t.device) for t in tensors]))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("anchors, gt_boxes, gt_labels and num_gt must be "
                         "contiguous")
    if anchors.data_ptr() % 16 or gt_boxes.data_ptr() % 16:
        raise ValueError("anchors and gt_boxes must start on a 16-byte "
                         "boundary")


def anchor_match(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_labels: torch.Tensor, num_gt: torch.Tensor,
                 num_classes: int) -> Targets:
    """Launch K3 on the current stream: CUDA anchors [A, 4], gt_boxes
    [B, G, 4] center format, gt_labels [B, G], num_gt [B] -> dense
    Targets, float32 and contiguous.  The four targets are views of one
    allocation (deterministic mode fills new memory once, not four
    times), each starting on a 16-byte boundary."""
    global LAUNCHES
    if anchors.device.type != "cuda":
        raise ValueError("K3 runs on CUDA tensors, got {}".format(
            anchors.device))
    check_inputs(anchors, gt_boxes, gt_labels, num_gt, num_classes)
    b, g = gt_labels.shape
    a = anchors.shape[0]
    p = plan(b, g, a)
    n = b * a
    mask_end = -(-n // 4) * 4
    out = torch.empty(mask_end + (8 + num_classes) * n, dtype=torch.float32,
                      device=anchors.device)
    mask = out[:n].view(b, a)
    deltas = out[mask_end:mask_end + 4 * n].view(b, a, 4)
    boxes = out[mask_end + 4 * n:mask_end + 8 * n].view(b, a, 4)
    labels = out[mask_end + 8 * n:].view(b, a, num_classes)
    fn = _cuda.function("anchor_match", "sdt_anchor_match", _ARGTYPES)
    with torch.cuda.device(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(anchors.data_ptr(), gt_boxes.data_ptr(),
                 gt_labels.data_ptr(), num_gt.data_ptr(), mask.data_ptr(),
                 deltas.data_ptr(), boxes.data_ptr(), labels.data_ptr(),
                 b, g, a, num_classes, _INDEX_DTYPES[gt_labels.dtype],
                 _INDEX_DTYPES[num_gt.dtype], p.cluster, p.slice, stream)
    _cuda.check("anchor_match", err, "anchor_match kernel launch")
    LAUNCHES += 1
    return Targets(input_mask=mask, box_delta_input=deltas, box_input=boxes,
                   labels=labels)
