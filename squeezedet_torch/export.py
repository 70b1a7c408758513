"""``squeezedet-torch-export``: build a deployable inference artifact
(counterpart of ``squeezedet_tpu/export.py``, same flags plus
``--device``).

    python -m squeezedet_torch.export --out_dir <dir> \\
        [--checkpoint <train_dir or caffe .pkl>] [--batch_size 8] \\
        [--quantize int8 --calib_images <file|dir|glob>] [--device cpu]

Traces the whole inference program, weights included, with
``torch.export`` on ``--device`` (``cuda`` by default, never falling back
to the CPU) through :func:`squeezedet_torch.serving.export_model`; a
serving host runs it with :func:`serving.load_exported` alone, on a
device of the same kind.
"""

from __future__ import annotations

import argparse


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a deployable squeezedet-torch inference "
                    "artifact (torch.export program + metadata).")
    p.add_argument('--net', default='squeezeDet',
                   help='Neural net architecture.')
    p.add_argument('--checkpoint', default='',
                   help='Checkpoint directory of the port (its newest '
                        'model.ckpt-<step>) or a caffe .pkl to bake in '
                        '(omit for seeded random weights, e.g. smoke '
                        'tests).')
    p.add_argument('--out_dir', required=True,
                   help='Artifact directory to write.')
    p.add_argument('--device', default='cuda',
                   help='torch device to trace on; the artifact runs on '
                        'this kind of device only. Never falls back.')
    p.add_argument('--batch_size', type=int, default=1)
    p.add_argument('--compute_dtype', default='bfloat16',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--f32_input', action='store_true',
                   help='Take mean-subtracted float32 images instead of '
                        'raw uint8 BGR.')
    p.add_argument('--no_postprocess', action='store_true',
                   help='Emit raw (det_boxes, det_probs, det_class) '
                        'instead of the on-device top-K + NMS outputs.')
    p.add_argument('--platforms', default='',
                   help='Comma-separated platforms of the artifact; a '
                        'torch.export program is traced on one device, so '
                        'only the kind of --device is taken (the default).')
    p.add_argument('--image_width', type=int, default=0,
                   help='Override input width (0 = model default).')
    p.add_argument('--image_height', type=int, default=0,
                   help='Override input height (0 = model default).')
    p.add_argument('--quantize', default='', choices=['', 'int8'],
                   help='Bake in the int8 PTQ program (quant.py); requires '
                        '--calib_images.')
    p.add_argument('--calib_images', default='',
                   help='Image file, directory or glob for --quantize '
                        'calibration (representative frames).')
    p.add_argument('--calib_percentile', type=float, default=None,
                   help='Calibrate activation ranges at this percentile of '
                        '|activation| instead of abs-max (saturating clip, '
                        'e.g. 99.99).')
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from squeezedet_torch.config import config_for_net_at
    from squeezedet_torch.demo import load_params
    from squeezedet_torch.models import get_model
    from squeezedet_torch.serving import export_model
    from squeezedet_torch.utils.util import resolve_device

    device = resolve_device(args.device, "the export")
    platforms = [p.strip() for p in args.platforms.split(',') if p.strip()]
    if platforms and platforms != [device.type]:
        raise SystemExit("--platforms {} : a torch.export artifact is traced "
                         "on one device, here {}".format(args.platforms,
                                                         device.type))
    if args.quantize and not args.calib_images:
        raise SystemExit("--quantize needs --calib_images")
    cfg = config_for_net_at(args.net, args.image_width,
                            args.image_height).replace(
        load_pretrained_model=False, batch_size=args.batch_size,
        compute_dtype=args.compute_dtype)
    det = load_params(get_model(args.net, cfg, device=device),
                      args.checkpoint)

    if args.quantize:
        from squeezedet_torch.quant import calib_batch_from_images
        calib = calib_batch_from_images(
            args.calib_images, cfg.image_width, cfg.image_height)
        print("Quantizing (int8 PTQ, {} calibration frames)...".format(
            len(calib)))
        det = det.quantize([calib], percentile=args.calib_percentile)

    export_model(det, args.out_dir, batch_size=args.batch_size,
                 uint8_input=not args.f32_input,
                 postprocess=not args.no_postprocess)
    print("Exported {} ({} input, {}{}) on {} -> {}".format(
        args.net, 'float32' if args.f32_input else 'uint8',
        'raw' if args.no_postprocess else 'postprocessed',
        ', int8' if args.quantize else '', device.type, args.out_dir))


if __name__ == '__main__':
    main()
