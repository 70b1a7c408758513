"""``squeezedet-torch-demo``: image and video detection (counterpart of
``squeezedet_tpu/demo.py``, same flags plus ``--device``).

    python -m squeezedet_torch.demo --input_path '<glob>' --out_dir <dir> \\
        --checkpoint <train_dir or caffe .pkl or none> [--device cpu]

Image mode: glob the inputs, resize to model resolution, detect, draw
class-coloured boxes, write ``out_<name>``.  Video mode: crop each frame
to ``[500:-205, 239:-439]`` (a 1920x1080 frame gives 375x1242), detect,
draw, write ``<n>.jpg`` and print per-frame timing.  Runs on ``--device``
(``cuda`` by default, never falling back to the CPU); every float
squeezeDet forward runs the K1 kernel there.  ``--quantize int8`` runs
the int8 program instead, calibrated on ``--calib_images`` (in image
mode, by default, on the input frames).  cv2 reads, resizes, draws and
writes, as in the JAX demo, imported where it is used.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

CLS2CLR = {
    'car': (255, 191, 0),
    'cyclist': (0, 191, 255),
    'pedestrian': (255, 0, 191),
}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SqueezeDet demo (PyTorch)")
    p.add_argument('--mode', default='image', choices=['image', 'video'])
    p.add_argument('--checkpoint',
                   default='./data/model_checkpoints/squeezeDet',
                   help='Checkpoint directory of the port (its newest '
                        'model.ckpt-<step>), a caffe .pkl weight file, or '
                        '"none" for seeded random weights.')
    p.add_argument('--input_path', default='./data/sample.png',
                   help='Image glob or video file.')
    p.add_argument('--out_dir', default='./data/out/')
    p.add_argument('--demo_net', default='squeezeDet')
    p.add_argument('--device', default='cuda',
                   help='torch device to detect on; never falls back.')
    p.add_argument('--compute_dtype', default='')
    p.add_argument('--quantize', default='', choices=['', 'int8'],
                   help='Run the int8 PTQ program (quant.py), calibrated '
                        'on --calib_images (default: the input images in '
                        'image mode).')
    p.add_argument('--calib_images', default='',
                   help='Image file, directory or glob for --quantize '
                        'calibration; required in video mode.')
    p.add_argument('--calib_percentile', type=float, default=None,
                   help='Calibrate activation ranges at this percentile of '
                        '|activation| instead of abs-max.')
    p.add_argument('--image_width', type=int, default=0,
                   help='Override input width (0 = model default).')
    p.add_argument('--image_height', type=int, default=0,
                   help='Override input height (0 = model default).')
    p.add_argument('--device_postprocess', action='store_true',
                   help='Run top-K + per-class NMS on the device instead of '
                        'the reference host-numpy filter_prediction (the '
                        'same detections); the demo keeps the host path by '
                        'default.')
    return p


def load_params(det, checkpoint: str):
    """Load weights into ``det`` from any supported source and return it.

    ``""`` or ``none``: the seeded random weights ``det`` was built with
    (a pipeline and timing smoke mode).  A directory: the params of its
    newest ``model.ckpt-<step>`` (never the optimizer state).  Else a
    caffe-layout pickle or a TF1 checkpoint (``checkpoint/importer.py``),
    through ``Detector.load_pretrained``."""
    from squeezedet_torch.checkpoint.importer import load_pretrained
    from squeezedet_torch.checkpoint.manager import (CheckpointManager,
                                                     latest_step)

    if checkpoint in ("", "none"):
        print('WARNING: --checkpoint none — random weights, detections '
              'are meaningless (timing/pipeline smoke mode)')
        return det
    if os.path.isdir(checkpoint):
        step = latest_step(checkpoint)
        if step is None:
            raise FileNotFoundError(
                'No model.ckpt-<step> directories in {}'.format(checkpoint))
        params = CheckpointManager(checkpoint).restore_params(
            step, det.backbone.state_dict())
        det.backbone.load_state_dict(params)
        print('Restored step {} from {}'.format(step, checkpoint))
        return det
    det.load_pretrained(load_pretrained(checkpoint))
    print('Imported legacy weights from {}'.format(checkpoint))
    return det


def _build(args, default_calib: str = ''):
    """(det, cfg) for the demo's net on ``--device``, with its weights;
    with ``--quantize``, its int8 twin (:func:`_maybe_quantize`)."""
    from squeezedet_torch.config import config_for_net_at
    from squeezedet_torch.models import get_model
    from squeezedet_torch.utils.util import resolve_device

    if args.demo_net not in ('squeezeDet', 'squeezeDet+'):
        raise SystemExit('Selected neural net architecture not supported: '
                         '{}'.format(args.demo_net))
    device = resolve_device(args.device, "the demo")
    cfg = config_for_net_at(args.demo_net, args.image_width,
                            args.image_height).replace(
        batch_size=1, load_pretrained_model=False)
    if args.compute_dtype:
        cfg = cfg.replace(compute_dtype=args.compute_dtype)
    det = load_params(get_model(args.demo_net, cfg, device=device),
                      args.checkpoint)
    return _maybe_quantize(args, det, default_calib), cfg


def _maybe_quantize(args, det, default_calib: str = ''):
    """``det``, or with ``--quantize int8`` its int8 twin calibrated on
    ``--calib_images`` (else ``default_calib``), which the demo's forward
    runs through ``predict_quant_normalized``."""
    if not args.quantize:
        return det
    calib_src = args.calib_images or default_calib
    if not calib_src:
        raise SystemExit('--quantize needs --calib_images')
    from squeezedet_torch.quant import calib_batch_from_images
    cfg = det.cfg
    calib = calib_batch_from_images(calib_src, cfg.image_width,
                                    cfg.image_height)
    print('Quantizing (int8 PTQ, {} calibration frames)...'.format(
        len(calib)))
    return det.quantize([calib], percentile=args.calib_percentile)


def _predict(det, im_input: np.ndarray, device_pp: bool):
    """One mean-subtracted frame [H, W, 3] -> the outputs as numpy
    arrays (the copy to the host waits for the device): the raw
    (boxes, probs, classes), or with ``device_pp`` the fixed-shape
    (boxes, probs, classes, keep), each with a batch axis of 1."""
    import torch
    x = torch.from_numpy(np.ascontiguousarray(im_input[None])).to(
        det.anchors.device)
    with torch.inference_mode():
        interp = det.predict_quant_normalized(x) if det.quantized else \
            det.predict(x)
        out = det.postprocess_device(interp) if device_pp else \
            (interp.det_boxes, interp.det_probs, interp.det_class)
    return tuple(o.cpu().numpy() for o in out)


def _filter_outputs(det, out, mc, device_pp: bool):
    """Final detections above ``plot_prob_thresh`` for one image.

    ``device_pp=False``: the reference protocol — ``out`` holds the raw
    (boxes, probs, classes), filtered by the host-numpy
    ``filter_prediction`` then thresholded.  ``device_pp=True``: ``out``
    is the device postprocess's fixed-shape (boxes, probs, classes,
    keep) [1, K, ...]; the same grouped-by-class ordering and threshold
    come from ``device_results_to_lists``."""
    if device_pp:
        from squeezedet_torch.ops.postprocess import device_results_to_lists
        k_boxes, k_probs, k_class, k_keep = out
        return device_results_to_lists(
            k_boxes[0], k_probs[0], k_class[0], k_keep[0],
            num_classes=mc.classes, plot_prob_thresh=mc.plot_prob_thresh)
    boxes, probs, classes = det.filter_prediction(out[0][0], out[1][0],
                                                  out[2][0])
    keep = [i for i in range(len(probs))
            if probs[i] > mc.plot_prob_thresh]
    return ([boxes[i] for i in keep], [probs[i] for i in keep],
            [classes[i] for i in keep])


def _draw(frame, boxes, probs, classes, mc):
    from squeezedet_torch.utils.util import draw_box
    draw_box(frame, boxes,
             ['%s: (%.2f)' % (mc.class_names[c], p)
              for c, p in zip(classes, probs)], cdict=CLS2CLR)


def _detect_and_draw(det, frame, im_input, mc, device_pp: bool = False):
    """Detect + filter + draw on ``frame`` in place; returns the final
    (boxes, probs, classes)."""
    boxes, probs, classes = _filter_outputs(
        det, _predict(det, im_input, device_pp), mc, device_pp)
    _draw(frame, boxes, probs, classes, mc)
    return boxes, probs, classes


def image_demo(args):
    import cv2

    det, cfg = _build(args, default_calib=args.input_path)
    for f in glob.iglob(args.input_path):
        im = cv2.imread(f).astype(np.float32)
        im = cv2.resize(im, (cfg.image_width, cfg.image_height))
        input_image = im - cfg.bgr_means_array()
        # draw on uint8: OpenCV >= 5 asserts CV_8U in putText
        im_draw = np.clip(im, 0, 255).astype(np.uint8)
        _detect_and_draw(det, im_draw, input_image, cfg,
                         device_pp=args.device_postprocess)
        file_name = os.path.split(f)[1]
        out_file_name = os.path.join(args.out_dir, 'out_' + file_name)
        cv2.imwrite(out_file_name, im_draw)
        print('Image detection output saved to {}'.format(out_file_name))


def video_demo(args):
    import cv2

    det, cfg = _build(args)
    cap = cv2.VideoCapture(args.input_path)
    count = 0
    while cap.isOpened():
        t_start = time.time()
        count += 1
        out_im_name = os.path.join(args.out_dir,
                                   str(count).zfill(6) + '.jpg')
        ret, frame = cap.read()
        if not ret:
            break
        frame = frame[500:-205, 239:-439, :]  # the reference demo's crop
        im_input = frame.astype(np.float32) - cfg.bgr_means_array()
        t_reshape = time.time()
        out = _predict(det, im_input, args.device_postprocess)
        t_detect = time.time()
        # with --device_postprocess the filter already ran on the device:
        # this phase is list bookkeeping
        boxes, probs, classes = _filter_outputs(
            det, out, cfg, args.device_postprocess)
        t_filter = time.time()
        _draw(frame, boxes, probs, classes, cfg)
        cv2.imwrite(out_im_name, frame)
        print('Total time: {:.4f}, detection time: {:.4f}, filter time: '
              '{:.4f}'.format(time.time() - t_start, t_detect - t_reshape,
                              t_filter - t_detect))
    cap.release()


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.mode == 'image':
        image_demo(args)
    else:
        video_demo(args)


if __name__ == '__main__':
    main()
