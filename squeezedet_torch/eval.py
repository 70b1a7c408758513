"""``squeezedet-torch-eval``: the checkpoint-polling eval daemon
(counterpart of ``squeezedet_tpu/eval.py``, same flags plus
``--device``).

    python -m squeezedet_torch.eval --data_path <kitti-root> \\
        --image_set val --checkpoint_path <train_dir> --eval_dir <dir> \\
        [--run_once] [--eval_batch_size 8] [--device cpu]

:func:`eval_checkpoint` detects every image of the split on ``--device``
(``cuda`` by default, never falling back to the CPU), rescales the boxes
to each image's resolution, writes KITTI det files, scores them and
writes AP/mAP/timing summaries.  :func:`main` polls the checkpoint
directory and scores each new step once.  Every float squeezeDet forward
runs the K1 kernel (``ops/fused_frontend.py``) on the card.
``--quantize int8`` scores the int8 program of each checkpoint,
calibrated on the split's first ``--calib_batches`` batches
(:func:`quantize_on_split`).

Over several devices the forward runs data-parallel, as the JAX
package's eval does on a mesh: one replica of the detector per device
(``--num_devices``; by default as many visible devices as divide the
batch), each on its rows of every batch, with no collective; under
``--device_dataset`` each replica holds its own shard of the split
(``Imdb.shard_data``, ``Imdb.eval_shard_batches``).  At batch 1 (the
reference protocol) over several devices the image is split spatially
instead, as the JAX eval does: float over ``N x 1`` height tiles, int8
over the JAX package's ``spatial_factors`` grid (single-device, with
its message, when that grid is 1 x 1); the backbone runs over the tiles
with halo exchanges and the head is gathered on ``--device``
(``models/halo.py``).  ``--native_loader`` reads each batch through the
C++ loader (``native/dataloader.py``), built at start.  Flags that stay
out of the port raise, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

# the split's uint8 canvas stack may take this much device memory
DEVICE_DATASET_GIB = 12.0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate SqueezeDet (PyTorch)")
    p.add_argument('--dataset', default='KITTI', help='KITTI or VOC.')
    p.add_argument('--data_path', default='', help='Root directory of data')
    p.add_argument('--image_set', default='test')
    p.add_argument('--year', default='2007', help='VOC challenge year.')
    p.add_argument('--eval_dir', default='/tmp/squeezedet_torch/logs/eval')
    p.add_argument('--checkpoint_path',
                   default='/tmp/squeezedet_torch/logs/train',
                   help='Training checkpoint directory, polled for '
                        'model.ckpt-<step> directories.')
    p.add_argument('--eval_interval_secs', type=int, default=60)
    p.add_argument('--run_once', action='store_true')
    p.add_argument('--net', default='squeezeDet')
    p.add_argument('--device', default='cuda',
                   help='torch device to evaluate on; never falls back.')
    p.add_argument('--eval_batch_size', type=int, default=1)
    p.add_argument('--num_devices', type=int, default=0,
                   help='Replicas of the detector, each on its rows of '
                        'every batch (0 = the most visible devices that '
                        'divide the batch); at --eval_batch_size 1, tiles '
                        'of each image (0 = every visible device). More '
                        'replicas or tiles than cards share them.')
    p.add_argument('--compute_dtype', default='')
    p.add_argument('--skip_analysis', action='store_true',
                   help='Skip the detection error-type analysis pass.')
    p.add_argument('--image_width', type=int, default=0,
                   help='Override input width (0 = model default).')
    p.add_argument('--image_height', type=int, default=0,
                   help='Override input height (0 = model default).')
    p.add_argument('--native_loader', action='store_true',
                   help='Use the C++ threaded batch loader for image IO '
                        '(builds squeezedet_torch/native/dataloader on '
                        'first use); without --device_dataset.')
    p.add_argument('--image_cache_mb', type=int, default=0,
                   help='Decoded-image LRU budget in MiB (0 = off); '
                        'repeated eval polls skip the image decode.')
    p.add_argument('--compilation_cache', default='',
                   help='XLA compilation cache (stays out of the port).')
    p.add_argument('--plot_pr', action='store_true',
                   help='Render recall/precision curve images from the '
                        'scorer plot data (matplotlib).')
    p.add_argument('--quantize', default='', choices=['', 'int8'],
                   help='Post-training int8 quantization: calibrate on the '
                        'first --calib_batches eval batches, then score the '
                        'int8 program (quant.py).')
    p.add_argument('--calib_batches', type=int, default=4,
                   help='Calibration batches for --quantize.')
    p.add_argument('--calib_percentile', type=float, default=None,
                   help='Calibrate activation ranges at this percentile of '
                        '|activation| instead of abs-max (saturating clip, '
                        'e.g. 99.99).')
    p.add_argument('--device_postprocess', action='store_true',
                   help='Run top-K + per-class NMS on the device instead '
                        'of the host-numpy filter_prediction (the same '
                        'detections). The default for batched eval '
                        '(--eval_batch_size > 1); batch 1 keeps the '
                        'reference host path unless this flag forces it.')
    p.add_argument('--host_postprocess', action='store_true',
                   help='Force the reference host-numpy filter_prediction '
                        'even for batched eval.')
    p.add_argument('--device_dataset', action='store_true',
                   help='Keep the eval split on the device as one uint8 '
                        'canvas stack (uploaded once, reused across '
                        'checkpoint polls) and resize and normalize there: '
                        'each poll sends only row positions and extents.')
    return p


def _reject_unported(args) -> None:
    """Flags of the JAX CLI that stay out of the port."""
    if args.compilation_cache:
        raise SystemExit('--compilation_cache is an XLA mechanism that '
                         'stays out of the port (ROADMAP Queue 1 item 14)')


def resolve_device_postprocess(args) -> bool:
    """Batched eval postprocesses on the device by default; batch 1 keeps
    the reference host path.  ``--device_postprocess`` and
    ``--host_postprocess`` force either (host wins when both are given)."""
    if args.host_postprocess:
        return False
    return args.device_postprocess or args.eval_batch_size > 1


def resolve_mesh(args, device):
    """The replicas' devices: ``--num_devices``, or with 0 the most
    visible devices that divide the batch (the JAX eval's ``auto_mesh``);
    None for one.  The batch must divide over them.  At batch 1, the
    devices the image is tiled over (:func:`detect_all`):
    ``--num_devices``, or with 0 every visible device."""
    from squeezedet_torch.parallel.mesh import (auto_mesh, make_mesh,
                                                visible_devices)
    if args.eval_batch_size == 1:
        n = args.num_devices or visible_devices(device)
        return make_mesh(n, device) if n > 1 else None
    if args.num_devices == 0:
        return auto_mesh(args.eval_batch_size, device) \
            if args.eval_batch_size > 1 else None
    if args.eval_batch_size % args.num_devices:
        raise SystemExit('--eval_batch_size {} is not divisible by '
                         '--num_devices {}: each replica takes an equal '
                         'share of a batch'.format(args.eval_batch_size,
                                                    args.num_devices))
    return make_mesh(args.num_devices, device) \
        if args.num_devices > 1 else None


def quantize_on_split(det, imdb, calib_batches: int, percentile=None):
    """The int8 twin of ``det`` (``quant.py``), calibrated on the first
    ``calib_batches`` batches of the split (unshuffled, the reader's
    cursor reset before and after).  ``det`` is left as it was."""
    from squeezedet_torch.quant import calibrate_normalized, \
        quantize_detector
    imdb.reset_cursor()

    def batches():
        for _ in range(calib_batches):
            images, _ = imdb.read_image_batch(shuffle=False)
            yield np.stack(images)

    qdet = quantize_detector(det, calibrate_normalized(
        det, batches(), percentile=percentile))
    imdb.reset_cursor()
    return qdet


def _eval_stacks(imdb, devices, sharded: bool):
    """The split's uint8 canvas stack on each replica's device: the
    whole split on one device, or under ``sharded`` replica k's padded
    shard (``Imdb.shard_data``).  Uploaded once and cached on the imdb, keyed
    by the placement, so a poll on the same devices reuses them and a
    changed placement uploads again."""
    import torch
    key = ", ".join(str(d) for d in devices) + (" sharded" if sharded
                                                else "")
    cached = getattr(imdb, '_eval_stack_dev', None)
    if cached is not None and cached[0] == key:
        return cached[1]
    h0, w0 = imdb.canvas_size()
    rows = imdb._shard_rows if sharded else len(imdb.image_idx)
    gib = rows * h0 * w0 * 3 / 2**30
    if gib > DEVICE_DATASET_GIB:
        raise ValueError(
            '--device_dataset eval: the {}-image split is {:.1f} GiB per '
            'device as a uint8 canvas stack (more than {} GiB next to the '
            'params on one device) — evaluate without --device_dataset, use '
            'more devices, or split the image set'.format(
                len(imdb.image_idx), gib, DEVICE_DATASET_GIB))
    if sharded:
        stacks = [torch.from_numpy(imdb.load_canvas_shards([k])).to(d)
                  for k, d in enumerate(devices)]
    else:
        (device,) = devices
        stacks = [torch.from_numpy(imdb.load_canvas_dataset()).to(device)]
    print('Device-resident eval split: {} images, {:.2f} GiB per device'
          '{}, uploaded once'.format(
              len(imdb.image_idx), gib,
              ' (sharded {} ways)'.format(len(devices)) if sharded else ''))
    imdb._eval_stack_dev = (key, stacks)
    return stacks


def spatial_tiling(det, devices):
    """The batch-1 eval's tiling over ``devices`` (the JAX eval's rule):
    float over ``N x 1`` height tiles, int8 over ``spatial_factors(N, H,
    W)``; None, with the JAX eval's message, when that grid is 1 x 1."""
    from squeezedet_torch.models.halo import Tiling
    from squeezedet_torch.parallel.mesh import spatial_factors
    n = len(devices)
    if det.quantized:
        n_h, n_w = spatial_factors(n, det.cfg.image_height,
                                   det.cfg.image_width)
    else:
        n_h, n_w = n, 1
    if n_h * n_w == 1:
        print('int8 spatial partitioning unavailable for this '
              'geometry (no height x width split of {} devices '
              'divides every conv stage evenly); evaluating '
              'single-device'.format(n))
        return None
    print('Evaluating spatially over {} devices'.format(n_h * n_w))
    return Tiling(n_h, n_w, tuple(devices[:n_h * n_w]))


def detect_all(det, imdb, batch_size: int, device_postprocess: bool = False,
               device_dataset: bool = False, mesh=None):
    """Run detection over the whole split with ``det``'s weights, on its
    device, or over ``mesh`` (devices, ``parallel.mesh.make_mesh``): one
    replica per device, each on its rows of every batch; at batch 1, the
    tiles of each image over those devices (:func:`spatial_tiling`), the
    frame resized on ``det``'s device and then tiled.

    The default is the reference protocol: the host reader resizes, the
    forward returns the raw interpretation, and the host's numpy
    ``filter_prediction`` runs after the boxes are rescaled to each
    image's resolution.  ``device_postprocess`` runs top-K + per-class
    NMS on the device at model resolution and rescales the K survivors:
    IoU, ranking and thresholds are scale-invariant, so the detections are
    the same.  ``device_dataset`` keeps the split on the device as one
    uint8 canvas stack (:func:`_eval_stack`) and gathers, resizes and
    normalizes each batch there (``augment_resize_normalize`` with zero
    drift and no flip); each batch sends only row positions and extents.
    Over a mesh each replica's device holds its shard of the split, and
    the batches follow the shard-major plan (``eval_shard_batches``),
    whose pad slots are dropped.

    The sequential reader wraps past the end of the split; the wrapped
    tail repeats images already scored and is dropped.  The ``im_detect``
    timer covers the copy of the outputs to the host, which waits for the
    device.

    Returns (all_boxes[cls][img] = [[x1, y1, x2, y2, score], ...],
    num_detection, timers dict).
    """
    import torch

    from squeezedet_torch.data.device_pipeline import \
        augment_resize_normalize
    from squeezedet_torch.ops.postprocess import device_results_to_lists
    from squeezedet_torch.parallel.mesh import (replicate, run_replicas,
                                                shard_slices)
    from squeezedet_torch.utils.util import Timer, bbox_transform

    if imdb.mc.batch_size != batch_size:
        # the readers take imdb.mc.batch_size images a call
        raise ValueError("batch_size {} but the imdb reads {} images a "
                         "batch".format(batch_size, imdb.mc.batch_size))
    cfg = det.cfg
    num_images = len(imdb.image_idx)
    all_boxes = [[[] for _ in range(num_images)]
                 for _ in range(imdb.num_classes)]
    timers = {'im_detect': Timer(), 'im_read': Timer(), 'misc': Timer()}
    spatial = None
    if batch_size == 1 and mesh and len(mesh) > 1:
        spatial, mesh = spatial_tiling(det, mesh), None
    replicas = replicate(det, mesh) if mesh else [det]
    devices = [d.anchors.device for d in replicas]
    slices = shard_slices(batch_size, len(replicas))
    if len(replicas) > 1:
        print('Evaluating data-parallel over {} replicas ({})'.format(
            len(replicas), ', '.join(str(d) for d in devices)))
    sharded = device_dataset and len(replicas) > 1
    if sharded:
        imdb.shard_data(len(replicas), batch_size)
    stacks = _eval_stacks(imdb, devices, sharded) if device_dataset \
        else None
    shard_rows = imdb._shard_rows if sharded else 0

    def predict(d, images):
        # an int8 detector (quantize_on_split) runs its int8 program
        forward = d.predict_quant_normalized if d.quantized else d.predict
        interp = forward(images, spatial)
        if device_postprocess:
            return d.postprocess_device(interp)
        return interp.det_boxes, interp.det_probs, interp.det_class

    def predict_rows(d, stack, pos, aug):
        canvas = stack.index_select(0, pos)
        return predict(d, augment_resize_normalize(
            canvas, aug, cfg.image_height, cfg.image_width, cfg.bgr_means))

    num_detection = 0.0
    imdb.reset_cursor()
    plan = list(imdb.eval_shard_batches(batch_size)) if sharded else None
    done_images = 0
    for bt in range(len(plan) if sharded else
                    -(-num_images // batch_size)):
        start = bt * batch_size
        timers['im_read'].tic()
        if sharded:
            pos, aug, scales, img_is = plan[bt]
        elif device_dataset:
            pos, aug, scales = imdb.read_image_rows()
            img_is = np.arange(start, start + len(scales))
        else:
            images, scales = imdb.read_image_batch(shuffle=False)
            img_is = np.arange(start, start + len(scales))
        img_is = np.where(img_is < num_images, img_is, -1)
        timers['im_read'].toc()

        timers['im_detect'].tic()
        with torch.inference_mode():
            if device_dataset:
                # each replica's rows of its own stack (its shard's block)
                outs = run_replicas(predict_rows, replicas, [
                    (stacks[k], torch.from_numpy(
                        pos[sl].astype(np.int64) - k * shard_rows).to(dev),
                     torch.from_numpy(aug[sl]).to(dev))
                    for k, (sl, dev) in enumerate(zip(slices, devices))])
            else:
                x = np.stack(images)
                outs = run_replicas(predict, replicas, [
                    (torch.from_numpy(x[sl]).to(dev),)
                    for sl, dev in zip(slices, devices)])
            # a copy: the boxes are rescaled in place below
            out = [np.concatenate([o[i].numpy() for o in outs])
                   for i in range(len(outs[0]))]
        timers['im_detect'].toc()

        timers['misc'].tic()
        for j, i in enumerate(img_is):
            if i < 0:
                continue  # the wrapped tail
            boxes_j = out[0][j]
            boxes_j[:, 0::2] /= scales[j][0]
            boxes_j[:, 1::2] /= scales[j][1]
            if device_postprocess:
                boxes, probs, classes = device_results_to_lists(
                    boxes_j, out[1][j], out[2][j], out[3][j],
                    imdb.num_classes)
            else:
                boxes, probs, classes = det.filter_prediction(
                    boxes_j, out[1][j], out[2][j])
            num_detection += len(boxes)
            for c, b, s in zip(classes, boxes, probs):
                all_boxes[c][i].append(bbox_transform(b) + [s])
        timers['misc'].toc()

        done_images += int((img_is >= 0).sum())
        print('im_detect: {:d}/{:d} im_read: {:.3f}s '
              'detect: {:.3f}s misc: {:.3f}s'.format(
                  done_images, num_images,
                  timers['im_read'].average_time,
                  timers['im_detect'].average_time,
                  timers['misc'].average_time))
    return all_boxes, num_detection, timers


def eval_checkpoint(det, imdb, global_step, *, eval_dir, batch_size=1,
                    summary_writer=None, skip_analysis=False, plot_pr=False,
                    quantize='', calib_batches=4, calib_percentile=None,
                    device_postprocess=False, device_dataset=False,
                    mesh=None):
    """Score ``det``'s weights as step ``global_step``: detect, write and
    score the det files, print and write the summaries, and analyse the
    errors.  With ``quantize='int8'`` the int8 twin of ``det`` is scored
    (:func:`quantize_on_split`).  ``mesh``: as :func:`detect_all`.
    Returns (aps, ap_names, mAP)."""
    if quantize:
        if quantize != 'int8':
            raise ValueError('quantize must be int8, got {!r}'.format(
                quantize))
        print('Quantizing (int8 PTQ, {} calibration batches)...'.format(
            calib_batches))
        det = quantize_on_split(det, imdb, calib_batches,
                                percentile=calib_percentile)
    all_boxes, num_detection, timers = detect_all(
        det, imdb, batch_size, device_postprocess=device_postprocess,
        device_dataset=device_dataset, mesh=mesh)
    print('Evaluating detections...')
    aps, ap_names = imdb.evaluate_detections(eval_dir, global_step,
                                             all_boxes)
    if plot_pr:
        from squeezedet_torch.utils.plots import render_pr_curves
        rendered = render_pr_curves(os.path.join(
            eval_dir, 'detection_files_{}'.format(global_step)))
        print('Rendered {} PR-curve images'.format(len(rendered)))
    num_images = len(imdb.image_idx)

    print('Evaluation summary:')
    print('  Average number of detections per image: {}:'.format(
        num_detection / num_images))
    print('  Timing:')
    print('    im_read: {:.3f}s detect: {:.3f}s misc: {:.3f}s'.format(
        timers['im_read'].average_time, timers['im_detect'].average_time,
        timers['misc'].average_time))
    print('  Average precisions:')
    for cls, ap in zip(ap_names, aps):
        print('    {}: {:.3f}'.format(cls, ap))
    mAP = float(np.mean(aps))
    print('    Mean average precision: {:.3f}'.format(mAP))

    if summary_writer is not None:
        step = int(global_step)
        for cls, ap in zip(ap_names, aps):
            summary_writer.scalar('APs/' + cls, ap, step)
        summary_writer.scalar('APs/mAP', mAP, step)
        summary_writer.scalar('timing/im_detect',
                              timers['im_detect'].average_time, step)
        summary_writer.scalar('timing/im_read',
                              timers['im_read'].average_time, step)
        summary_writer.scalar('timing/post_proc',
                              timers['misc'].average_time, step)
        summary_writer.scalar('num_det_per_image',
                              num_detection / num_images, step)
        summary_writer.flush()

    if not skip_analysis and hasattr(imdb, 'do_detection_analysis_in_eval'):
        # the error-type taxonomy is KITTI's
        print('Analyzing detections...')
        imdb.do_detection_analysis_in_eval(eval_dir, global_step)
    return aps, ap_names, mAP


def main(argv=None):
    """Poll ``--checkpoint_path`` and score each new step once (the first
    one only, with ``--run_once``)."""
    args = build_arg_parser().parse_args(argv)
    _reject_unported(args)
    from squeezedet_torch.utils.util import resolve_device
    device = resolve_device(args.device, "eval")

    from squeezedet_torch.checkpoint.manager import (CheckpointManager,
                                                     latest_step)
    from squeezedet_torch.config import config_for_dataset
    from squeezedet_torch.data import imdb_for_dataset
    from squeezedet_torch.models import get_model
    from squeezedet_torch.summary import SummaryWriter

    cfg = config_for_dataset(args.dataset, args.net, args.image_width,
                             args.image_height)
    cfg = cfg.replace(batch_size=args.eval_batch_size,
                      load_pretrained_model=False, is_training=False)
    if args.compute_dtype:
        cfg = cfg.replace(compute_dtype=args.compute_dtype)
    if args.image_cache_mb:
        cfg = cfg.replace(image_cache_mb=args.image_cache_mb)
    if args.native_loader:
        from squeezedet_torch.native import dataloader
        try:
            dataloader.load()
        except RuntimeError as e:
            raise SystemExit('--native_loader: {}'.format(e))
        if args.device_dataset:
            print('WARNING: --native_loader reads the host-resized feed; '
                  '--device_dataset resizes on the device and reads no '
                  'pixels per poll.')
        cfg = cfg.replace(use_native_loader=True)
    det = get_model(args.net, cfg, device=device)
    imdb = imdb_for_dataset(args.dataset, args.image_set, args.data_path,
                            cfg, year=args.year)
    mesh = resolve_mesh(args, device)
    os.makedirs(args.eval_dir, exist_ok=True)
    writer = SummaryWriter(args.eval_dir)

    # params only: an inference job never reads the optimizer state
    params_like = det.backbone.state_dict()
    ckpt = CheckpointManager(args.checkpoint_path)
    seen = set()
    try:
        while True:
            step = latest_step(args.checkpoint_path)
            if step is None or step in seen:
                if step is None:
                    print('No checkpoint file found')
                if args.run_once:
                    return
                print('Wait {:d}s for new checkpoints to be saved ... '
                      .format(args.eval_interval_secs))
                time.sleep(args.eval_interval_secs)
                continue
            seen.add(step)
            print('Evaluating step {}...'.format(step))
            det.backbone.load_state_dict(ckpt.restore_params(step,
                                                             params_like))
            eval_checkpoint(det, imdb, step, eval_dir=args.eval_dir,
                            batch_size=args.eval_batch_size,
                            summary_writer=writer,
                            skip_analysis=args.skip_analysis,
                            plot_pr=args.plot_pr,
                            quantize=args.quantize,
                            calib_batches=args.calib_batches,
                            calib_percentile=args.calib_percentile,
                            device_postprocess=resolve_device_postprocess(
                                args),
                            device_dataset=args.device_dataset,
                            mesh=mesh)
            if args.run_once:
                return
    finally:
        writer.close()


if __name__ == '__main__':
    main()
