"""The single-device train step (counterpart of the step builders in
``squeezedet_tpu/trainer.py``).

One step is forward (dropout on) + interpretation + loss + backward +
the optimizer chain, on the detector's device.  PyTorch updates in
place: the step changes the detector's parameters and the optimizer's
momentum buffers and step count, which :class:`TrainState` bundles, and
returns the (detached) loss terms.  The weight gradients of eligible
convs come from K2 when ``layers.set_filter_grad`` routes them there.

Not ported yet, each raising ``NotImplementedError``: the device-resident
dataset, the scanned multi-step dispatch and meshes (ROADMAP Queue 1
items 7 and 13), and the train loop ``train`` (item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from squeezedet_torch.data.device_pipeline import ingest_and_assign
from squeezedet_torch.models import Detector
from squeezedet_torch.models.skeleton import LossBreakdown, Targets
from squeezedet_torch.optim import Momentum


@dataclass
class TrainState:
    """What a train step updates in place: ``det``'s parameters and
    ``opt``'s momentum buffers and step count."""

    det: Detector
    opt: Momentum

    @property
    def step(self) -> int:
        return self.opt.step


def _apply_update(state: TrainState, images: torch.Tensor, targets: Targets,
                  generator: Optional[torch.Generator]) -> LossBreakdown:
    """Forward + backward + optimizer update, shared by every step
    builder.  Frozen parameters (``requires_grad=False``) get no
    gradient, and nothing is differentiated through them."""
    state.opt.zero_grad()
    lb = state.det.loss(images, targets, generator, train=True)
    lb.total.backward()
    state.opt.update()
    return LossBreakdown(*(t.detach() for t in lb))


def make_train_step(state: TrainState):
    """Step on dense targets: ``(images, targets, generator) ->
    LossBreakdown``, with mean-subtracted images."""
    def step_fn(images, targets: Targets, generator=None):
        return _apply_update(state, images, targets, generator)
    return step_fn


def make_train_step_device(state: TrainState, *, uint8_ingest: bool = False,
                           device_augment: bool = False,
                           device_dataset: bool = False, mesh=None):
    """Step with the anchor matcher on the device.

    Signature: ``(images, gt_boxes, gt_labels, num_gt, generator) ->
    LossBreakdown``, GT padded to G slots per image.  ``uint8_ingest``:
    images arrive as raw uint8 and are mean-subtracted on the device.
    ``device_augment``: images are a raw uint8 canvas batch and the
    signature gains ``aug`` [B, 5] after ``images``
    (``augment_resize_normalize``).
    """
    if device_dataset:
        raise NotImplementedError(
            "device_dataset needs the ported host data layer "
            "(ROADMAP Queue 1 item 7)")
    if mesh is not None:
        raise NotImplementedError("meshes: ROADMAP Queue 1 item 13")
    det = state.det

    if device_augment:
        def step_fn(images, aug, gt_boxes, gt_labels, num_gt,
                    generator=None):
            images, targets = ingest_and_assign(
                det, images, gt_boxes, gt_labels, num_gt, uint8_ingest,
                aug=aug)
            return _apply_update(state, images, targets, generator)
    else:
        def step_fn(images, gt_boxes, gt_labels, num_gt, generator=None):
            images, targets = ingest_and_assign(
                det, images, gt_boxes, gt_labels, num_gt, uint8_ingest)
            return _apply_update(state, images, targets, generator)
    return step_fn


def make_train_step_device_scan(*args, **kwargs):
    """K steps per dispatch (``--steps_per_dispatch``); on the card this
    becomes CUDA-graph capture."""
    raise NotImplementedError(
        "the scanned multi-step dispatch: ROADMAP Queue 1 item 7")


def train(*args, **kwargs):
    """The train loop with checkpoints, summaries and resume."""
    raise NotImplementedError(
        "the train loop, checkpoints and train CLI: ROADMAP Queue 1 item 7")
