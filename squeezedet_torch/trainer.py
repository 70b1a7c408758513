"""The single-device train step and the train loop (counterpart of
``squeezedet_tpu/trainer.py``).

One step is forward (dropout on) + interpretation + loss + backward +
the optimizer chain, on the detector's device.  PyTorch updates in
place: the step changes the detector's parameters and the optimizer's
momentum buffers and step count, which :class:`TrainState` bundles, and
returns the (detached) loss terms.  The weight gradients of eligible
convs come from K2 when ``layers.set_filter_grad`` routes them there.

:func:`train` is the loop of the train CLI: prefetched batches, the log,
summary and checkpoint cadences with the NaN gate, checkpoints with the
input-stream snapshot for exact resume, ``model_metrics.txt``, and the
summary-step histograms and detection images.

Not ported, each raising ``NotImplementedError`` naming its ROADMAP
Queue 1 item: meshes (13), the scanned multi-step dispatch (16, as CUDA
graphs), activation summaries (19); ``rng_impl`` stays out (14).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from squeezedet_torch.data.device_pipeline import ingest_and_assign
from squeezedet_torch.models import Detector
from squeezedet_torch.models.skeleton import LossBreakdown, Targets
from squeezedet_torch.optim import Momentum, build_optimizer, learning_rate_at

# the largest uint8 canvas stack --device_dataset keeps on the device
DEVICE_DATASET_MAX_GIB = 12.0


@dataclass
class TrainState:
    """What a train step updates in place: ``det``'s parameters and
    ``opt``'s momentum buffers and step count."""

    det: Detector
    opt: Momentum

    @property
    def step(self) -> int:
        return self.opt.step

    def as_tree(self) -> dict:
        """The checkpointed tree (live tensors; the checkpoint manager
        copies them to the CPU)."""
        return {"params": self.det.backbone.state_dict(),
                "opt_state": self.opt.state_dict(), "step": self.step}

    def load_tree(self, tree: dict) -> None:
        self.det.backbone.load_state_dict(tree["params"])
        self.opt.load_state_dict(tree["opt_state"])
        if int(tree["step"]) != self.opt.step:
            raise ValueError("checkpoint step {} != its optimizer step "
                             "{}".format(int(tree["step"]), self.opt.step))


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
    (``augment_resize_normalize``).  ``device_dataset``: the signature
    is ``(dataset, pos, aug, gt_boxes, gt_labels, num_gt, generator)``;
    the step gathers its canvas rows ``pos`` from the uint8 stack
    ``dataset`` [N, H0, W0, 3] on the device, then augments as above.
    """
    if mesh is not None:
        raise NotImplementedError("meshes: ROADMAP Queue 1 item 13")
    det = state.det

    if device_dataset:
        def step_fn(dataset, pos, aug, gt_boxes, gt_labels, num_gt,
                    generator=None):
            canvas = torch.index_select(dataset, 0, pos.long())
            images, targets = ingest_and_assign(
                det, canvas, gt_boxes, gt_labels, num_gt, uint8_ingest,
                aug=aug)
            return _apply_update(state, images, targets, generator)
    elif device_augment:
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
        "the scanned multi-step dispatch (--steps_per_dispatch > 1, CUDA "
        "graphs on the card): ROADMAP Queue 1 item 16")


def _sampler_ckpt_path(train_dir: str, step: int) -> str:
    """Input-stream snapshot path of a checkpoint step."""
    return os.path.join(train_dir, "sampler.ckpt-{}.npz".format(step))


def _write_loss_summaries(summary_writer, cfg, step: int, lb) -> None:
    """Per-step scalars: the loss terms, mean IoU and learning rate."""
    summary_writer.scalar("loss/total_loss", float(lb.total), step)
    summary_writer.scalar("loss/confidence_loss", float(lb.conf_loss),
                          step)
    summary_writer.scalar("loss/bounding_box_loss", float(lb.bbox_loss),
                          step)
    summary_writer.scalar("loss/class_loss", float(lb.class_loss), step)
    summary_writer.scalar("mean_iou", float(lb.mean_iou), step)
    summary_writer.scalar("learning_rate", learning_rate_at(cfg, step),
                          step)


def _dispatch_cadences(covered, lb, *, start_time, cfg, log_every,
                       summary_step, summary_writer, checkpoint_step,
                       max_steps, force_materialize=False):
    """The log, loss-summary and checkpoint cadences over the steps
    ``covered`` by one dispatch, and the NaN gate.

    Loss values leave the device only when a cadence fires (or
    ``force_materialize``): quiet steps stay asynchronous, so host work
    overlaps the device.  Returns ``(summary_due, checkpoint_due,
    totals)``, ``totals`` the per-step losses (None when nothing fired).
    """
    last = covered[-1]
    do_log = any(s % log_every == 0 for s in covered)
    do_summary = summary_writer is not None and summary_step > 0 and any(
        s % summary_step == 0 for s in covered)
    checkpoint_due = any(s % checkpoint_step == 0 for s in covered) \
        or last + 1 == max_steps
    totals = None
    if do_log or do_summary or checkpoint_due or force_materialize:
        terms = {name: getattr(lb, name).detach().reshape(-1).cpu().numpy()
                 for name in ("total", "conf_loss", "bbox_loss",
                              "class_loss")}
        totals = terms["total"]
        if np.isnan(totals).any():
            raise FloatingPointError(
                'Model diverged. Losses in steps [{}..{}]: total {}, conf '
                '{}, bbox {}, class {}'.format(
                    covered[0], last, totals, terms["conf_loss"],
                    terms["bbox_loss"], terms["class_loss"]))
    if do_log:
        duration = time.time() - start_time
        k = len(covered)
        per = ('%.3f sec/batch' % duration) if k == 1 else \
            ('%.3f sec/%d-step dispatch' % (duration, k))
        print('%s: step %d, loss = %.2f (%.1f images/sec; %s)' % (
            datetime.now(), last, float(totals[-1]),
            cfg.batch_size * k / duration, per))
        sys.stdout.flush()
    if do_summary:
        lb_last = LossBreakdown(*(float(t.detach().reshape(-1)[-1])
                                  for t in lb))
        _write_loss_summaries(summary_writer, cfg, last, lb_last)
    return do_summary, checkpoint_due, totals


def _save_checkpoint(ckpt, train_dir: str, imdb, loader, generator,
                     state: TrainState, *, next_step: int, max_steps: int,
                     totals) -> None:
    """Divergence-gated checkpoint + input-stream snapshot, saved under
    the last covered step (``next_step - 1``).  The manager copies the
    state to the CPU before the background write starts (the next step
    updates it in place); only the final save blocks.

    The snapshot is the consumed batch's sampler state (carried through
    the prefetch queue with each item), so resume redraws exactly the
    batches after the last one trained on, and the dropout generator's
    state, so its draws continue too.
    """
    totals = np.asarray(totals)
    if not np.isfinite(totals).all():
        raise FloatingPointError(
            'Model diverged (losses = {}); refusing to checkpoint at step '
            '{}'.format(totals, next_step - 1))
    ckpt.save(next_step - 1, state.as_tree(), wait=next_step == max_steps)
    stream_state = loader.consumed_state() or imdb.sampler_state()
    np.savez(_sampler_ckpt_path(train_dir, next_step - 1),
             torch_rng_state=generator.get_state().numpy(), **stream_state)


def viz_prediction_images(det: Detector, images_np, targets,
                          max_images: int = 8):
    """Draw GT (green) and filtered predictions (red) on the batch, from
    mean-subtracted BGR f32 images; returns [N, H, W, 3] uint8 RGB."""
    from squeezedet_torch.utils.util import draw_box

    cfg = det.cfg
    dev = det.anchors.device
    interp = det.predict(torch.from_numpy(np.asarray(images_np)).to(dev))
    det_boxes, det_probs, det_class = (
        t.cpu().numpy() for t in (interp.det_boxes, interp.det_probs,
                                  interp.det_class))
    mask, gt_boxes, labels = (t.cpu().numpy() for t in (
        targets.input_mask, targets.box_input, targets.labels))

    out = []
    for i in range(min(max_images, images_np.shape[0])):
        im = (images_np[i] + cfg.bgr_means_array()).clip(0, 255) \
            .astype(np.uint8).copy()
        owned = np.nonzero(mask[i] > 0)[0]
        draw_box(im, [gt_boxes[i, a] for a in owned],
                 [cfg.class_names[int(np.argmax(labels[i, a]))]
                  for a in owned], (0, 255, 0))
        boxes, probs, classes = det.filter_prediction(
            det_boxes[i], det_probs[i], det_class[i])
        keep = [k for k in range(len(probs))
                if probs[k] > cfg.plot_prob_thresh]
        draw_box(im, [boxes[k] for k in keep],
                 ['%s: (%.2f)' % (cfg.class_names[classes[k]], probs[k])
                  for k in keep], (0, 0, 255))
        out.append(im[:, :, ::-1])  # BGR -> RGB
    return np.stack(out) if out else np.zeros((0, 1, 1, 3), np.uint8)


def _summary_tag(name: str) -> str:
    """Backbone state_dict name -> the JAX package's summary tag, e.g.
    'fire2.squeeze1x1.weight' -> 'fire2/squeeze1x1/kernel'."""
    *layers, leaf = name.split(".")
    return "/".join(layers + ["kernel" if leaf == "weight" else leaf])


def write_histograms(summary_writer, params, grads, step: int) -> None:
    """Histograms of each trainable parameter and its gradient
    (``params`` and ``grads``: name -> tensor, trainable leaves only)."""
    for prefix, tree in (("params", params), ("gradients", grads)):
        for name, leaf in tree.items():
            summary_writer.histogram(
                "{}/{}".format(prefix, _summary_tag(name)),
                leaf.detach().float().cpu().numpy(), step)


def trainable_grads(det: Detector, images, targets: Targets, generator):
    """Gradients of the train loss at ``det``'s current parameters, for
    the trainable leaves only (frozen conv1 is not differentiated, so
    K1's CUDA path, which refuses a gradient, stays usable); ``.grad``
    fields are left alone."""
    params = {n: p for n, p in det.backbone.named_parameters()
              if p.requires_grad}
    total = det.loss(images, targets, generator, train=True).total
    grads = torch.autograd.grad(total, list(params.values()))
    return params, dict(zip(params, grads))


def train(det: Detector, imdb, *, train_dir: str, max_steps: int,
          summary_step: int = 10, checkpoint_step: int = 1000,
          seed: int = 0, mesh=None, resume: bool = True,
          summary_writer=None, log_every: int = 10,
          pretrained: Optional[dict] = None,
          viz_step: int = 0, step_tracer=None,
          device_assign: bool = False, max_gt: int = 48,
          histogram_step: int = 0,
          activation_summary: bool = False,
          uint8_ingest: bool = False,
          steps_per_dispatch: int = 1,
          rng_impl: str = "",
          pallas_grads: bool = False,
          max_to_keep: int = 5,
          device_augment: bool = False,
          device_dataset: bool = False) -> TrainState:
    """The train loop, on ``det``'s device, updating ``det`` in place.

    ``pretrained`` (caffe-pickle layout) or the config's
    ``pretrained_model_path`` load before training; a checkpoint in
    ``train_dir`` then wins (auto-resume, with the input stream and the
    dropout generator restored).  ``seed`` seeds the dropout generator;
    the imdb's own RandomState drives the sampler.  ``pallas_grads``
    routes the eligible 1x1 weight gradients through K2 for this call.
    Returns the final :class:`TrainState`.
    """
    from squeezedet_torch.checkpoint.manager import CheckpointManager
    from squeezedet_torch.loader import PrefetchLoader
    from squeezedet_torch.models import layers
    from squeezedet_torch.utils.metrics import write_model_metrics

    cfg = det.cfg
    if mesh is not None:
        raise NotImplementedError("meshes: ROADMAP Queue 1 item 13")
    if rng_impl:
        raise NotImplementedError(
            "rng_impl is a JAX PRNG choice and stays out of the port "
            "(ROADMAP Queue 1 item 14)")
    if steps_per_dispatch > 1:
        make_train_step_device_scan()
    if activation_summary:
        raise NotImplementedError(
            "activation summaries (Detector.activation_stats): ROADMAP "
            "Queue 1 item 19")
    if uint8_ingest and not device_assign:
        raise ValueError("--uint8_ingest requires --device_assign (the "
                         "dense-target path feeds mean-subtracted f32 "
                         "images like the reference)")
    if device_dataset:
        device_augment = True  # the same on-device pixel pipeline
    if device_augment and not device_assign:
        raise ValueError("--device_augment requires --device_assign (the "
                         "canvas path feeds the on-device matcher)")
    writer_on = summary_writer is not None and \
        getattr(summary_writer, "enabled", True)
    if writer_on and viz_step:
        try:
            import cv2  # noqa: F401
        except ImportError:
            print("WARNING: the detection images of summary steps draw "
                  "with OpenCV (cv2), which is not installed; training "
                  "writes the other summaries without them.")
            viz_step = 0
    os.makedirs(train_dir, exist_ok=True)
    dev = det.anchors.device

    if pretrained is None and cfg.load_pretrained_model and \
            cfg.pretrained_model_path:
        from squeezedet_torch.checkpoint.importer import load_pretrained
        pretrained = load_pretrained(cfg.pretrained_model_path)
    if pretrained is not None:
        det.load_pretrained(pretrained)
    state = TrainState(det, build_optimizer(cfg, det))
    generator = torch.Generator(device=dev).manual_seed(seed)

    write_model_metrics(os.path.join(train_dir, "model_metrics.txt"),
                        det.tracer)

    ckpt = CheckpointManager(train_dir, max_to_keep=max_to_keep)
    if resume:
        step, restored = ckpt.restore_latest(state.as_tree())
        if step is not None:
            state.load_tree(restored)
            print("Resumed from step {}".format(state.step))
            sampler_file = _sampler_ckpt_path(train_dir, step)
            if os.path.exists(sampler_file):
                with np.load(sampler_file) as data:
                    data = dict(data)
                rng_state = data.pop("torch_rng_state", None)
                imdb.set_sampler_state(data)
                if rng_state is not None:
                    generator.set_state(torch.from_numpy(rng_state))
                print("Restored input-stream state ({})".format(
                    os.path.basename(sampler_file)))

    if device_assign:
        train_step = make_train_step_device(state, uint8_ingest=uint8_ingest,
                                            device_augment=device_augment,
                                            device_dataset=device_dataset)
    else:
        train_step = make_train_step(state)

    dataset_dev = None
    if device_dataset:
        # the guard is computed from the headers, before any decode
        h0, w0 = imdb.canvas_size()
        n_total = len(imdb.image_idx)
        gib = n_total * h0 * w0 * 3 / 2**30
        if gib > DEVICE_DATASET_MAX_GIB:
            raise ValueError(
                "--device_dataset: the {}-image split is {:.1f} GiB as a "
                "uint8 canvas stack, more than the {} GiB kept beside the "
                "model on the device; use --device_augment (a per-step "
                "canvas feed) instead".format(n_total, gib,
                                              DEVICE_DATASET_MAX_GIB))
        dataset_dev = torch.from_numpy(imdb.load_canvas_dataset()).to(dev)
        print("Device-resident dataset: {} images, {:.2f} GiB, uploaded "
              "once".format(n_total, dataset_dev.numel() / 2**30))

    def to_dev(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    def summary_pixels(host_batch):
        """Mean-subtracted f32 model-resolution pixels of this batch, as
        the step saw them (under device_augment the augment program is
        replayed on the batch's canvas rows)."""
        from squeezedet_torch.data.device_pipeline import (
            augment_resize_normalize)
        if not device_augment:
            images = np.asarray(host_batch[0])
            if uint8_ingest:
                return images.astype(np.float32) - cfg.bgr_means_array()
            return images
        if device_dataset:
            canvas = torch.index_select(dataset_dev, 0,
                                        to_dev(host_batch[0]).long())
        else:
            canvas = to_dev(host_batch[0])
        with torch.no_grad():
            pixels = augment_resize_normalize(
                canvas, to_dev(host_batch[1]), cfg.image_height,
                cfg.image_width, cfg.bgr_means)
        return pixels.cpu().numpy()

    def summary_targets(host_batch):
        """Dense targets of this batch for the detection images and the
        gradient recompute."""
        from squeezedet_torch.data.device_pipeline import (
            assign_anchors_device)
        if not device_assign:
            return host_batch[1]
        off = 2 if device_augment else 1
        gt, labels, num_gt = (to_dev(x) for x in host_batch[off:off + 3])
        return assign_anchors_device(det.anchors, gt.float(), labels,
                                     num_gt, cfg.classes)

    loader = PrefetchLoader(imdb, device_targets=device_assign,
                            max_gt=max_gt, uint8_images=uint8_ingest,
                            device_augment=device_augment,
                            device_dataset=device_dataset).start()
    prev_mode = layers.filter_grad_mode()
    if pallas_grads:
        layers.set_filter_grad("1x1")
    try:
        for step in range(state.step, max_steps):
            if step_tracer is not None:
                step_tracer.on_step(step)
            start_time = time.time()
            hist_due = writer_on and histogram_step and \
                step % histogram_step == 0
            # the histogram gradients replay this step's dropout draws
            step_rng = generator.get_state() if hist_due else None
            host_batch = loader.get()
            if device_dataset:
                lb = train_step(dataset_dev,
                                *(to_dev(x) for x in host_batch),
                                generator=generator)
            elif device_assign:
                lb = train_step(*(to_dev(x) for x in host_batch),
                                generator=generator)
            else:
                images, targets = host_batch
                lb = train_step(to_dev(images),
                                Targets(*(t.to(dev) for t in targets)),
                                generator=generator)

            do_summary, ckpt_due, totals = _dispatch_cadences(
                range(step, step + 1), lb, start_time=start_time,
                cfg=cfg, log_every=log_every, summary_step=summary_step,
                summary_writer=summary_writer,
                checkpoint_step=checkpoint_step, max_steps=max_steps)
            viz_due = writer_on and do_summary and viz_step and \
                step % viz_step == 0
            if viz_due or hist_due:
                pixels = summary_pixels(host_batch)
                targets = summary_targets(host_batch)
            if viz_due:
                summary_writer.image(
                    "sample_detection_results",
                    viz_prediction_images(det, pixels, targets), step,
                    max_outputs=cfg.batch_size)
            if hist_due:
                # grads at the post-update params of the same batch
                params, grads = trainable_grads(
                    det, to_dev(pixels), Targets(*(t.to(dev)
                                                   for t in targets)),
                    torch.Generator(device=dev).set_state(step_rng))
                write_histograms(summary_writer, params, grads, step)
            if ckpt_due:
                _save_checkpoint(ckpt, train_dir, imdb, loader, generator,
                                 state, next_step=step + 1,
                                 max_steps=max_steps, totals=totals)
        return state
    finally:
        layers.set_filter_grad(prev_mode)
        if step_tracer is not None:
            step_tracer.close()
        loader.stop()
        ckpt.wait_until_finished()
