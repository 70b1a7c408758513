"""``squeezedet-torch-quant-report``: per-layer int8 quantization error
(counterpart of ``squeezedet_tpu/tools/quant_report.py``).

Runs the float and int8 forwards side by side on calibration frames and
prints, per taped layer, the calibrated scale, the int8 utilization (how
much of [-128, 127] the activations use) and the signal-to-noise ratio
of the dequantized int8 activation against the float one.  A layer whose
SNR collapses (an outlier-stretched scale, a bad boundary) is the one to
move the ``start`` boundary past or to calibrate with a percentile.

    python -m squeezedet_torch.tools.quant_report --net squeezeDet \\
        [--checkpoint <dir or .pkl>] [--calib_images <file|dir|glob>] \\
        [--image_width W --image_height H] [--percentile 99.99] \\
        [--device cpu]

Without --checkpoint it reports on seeded random weights; without
--calib_images on uniform random frames drawn from a seed.
"""

from __future__ import annotations

import argparse

import numpy as np


def snr_db(ref, approx) -> float:
    ref = np.asarray(ref, np.float64).ravel()
    err = ref - np.asarray(approx, np.float64).ravel()
    num = float(np.sum(ref * ref))
    den = float(np.sum(err * err))
    if den == 0.0:
        return float("inf")
    return 10.0 * float(np.log10(num / max(den, 1e-300)))


def report(det, u8_batch, percentile=None, start=""):
    """Rows of (layer, scale, int8 utilization %, SNR dB) for the float
    ``det`` and its int8 twin calibrated on ``u8_batch``; returns (rows,
    the int8 detector)."""
    import torch

    from squeezedet_torch.data.device_pipeline import normalize_images
    from squeezedet_torch.quant import calibrate, quantize_detector

    scales = calibrate(det, [u8_batch], percentile=percentile)
    qdet = quantize_detector(det, scales, start=start)
    u8 = torch.as_tensor(np.asarray(u8_batch)).to(det.anchors.device)
    ft, qt = {}, {}
    with torch.inference_mode():
        det.backbone(normalize_images(u8, det.cfg.bgr_means,
                                      det.compute_dtype), tape=ft)
        qdet.backbone(qdet.quant_input(u8), tape=qt)

    rows = []
    for name in ft:
        f = ft[name].float().cpu().numpy()
        q = qt[name].cpu()
        if q.dtype == torch.int8:
            q = q.numpy()
            deq = q.astype(np.float32) * (scales[name] / 127.0)
            util = 100.0 * float(np.abs(q).max()) / 127.0
        else:
            deq = q.float().numpy()  # a float layer, or the f32 head
            util = float("nan")
        rows.append((name, scales[name] / 127.0, util, snr_db(f, deq)))
    return rows, qdet


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Per-layer int8 PTQ error report.")
    ap.add_argument("--net", default="squeezeDet")
    ap.add_argument("--checkpoint", default="",
                    help="Checkpoint directory of the port or a caffe .pkl "
                         "(omit for seeded random weights).")
    ap.add_argument("--calib_images", default="",
                    help="Image file/dir/glob (omit for synthetic frames).")
    ap.add_argument("--image_width", type=int, default=0)
    ap.add_argument("--image_height", type=int, default=0)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--percentile", type=float, default=None)
    ap.add_argument("--start", default="",
                    help="First quantized layer (default per net).")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on; never falls back.")
    args = ap.parse_args(argv)

    from squeezedet_torch.config import config_for_dataset
    from squeezedet_torch.demo import load_params
    from squeezedet_torch.models import get_model
    from squeezedet_torch.utils.util import resolve_device

    device = resolve_device(args.device, "the quant report")
    cfg = config_for_dataset("KITTI", args.net, args.image_width,
                             args.image_height)
    cfg = cfg.replace(batch_size=args.batch_size,
                      load_pretrained_model=False)
    det = load_params(get_model(args.net, cfg, device=device),
                      args.checkpoint)

    if args.calib_images:
        from squeezedet_torch.quant import calib_batch_from_images
        u8 = calib_batch_from_images(args.calib_images, cfg.image_width,
                                     cfg.image_height,
                                     limit=args.batch_size)
    else:
        u8 = np.random.RandomState(0).randint(
            0, 255, (args.batch_size, cfg.image_height,
                     cfg.image_width, 3), np.uint8)

    rows, _ = report(det, u8, percentile=args.percentile, start=args.start)
    print("{:<24s} {:>12s} {:>8s} {:>9s}".format(
        "layer", "scale", "util%", "SNR dB"))
    for name, scale, util, db in rows:
        print("{:<24s} {:>12.6f} {:>8s} {:>9.1f}".format(
            name, scale,
            "-" if util != util else "{:.0f}".format(util), db))
    worst = min((r for r in rows if r[3] == r[3]), key=lambda r: r[3])
    print("worst layer: {} ({:.1f} dB)".format(worst[0], worst[3]))


if __name__ == "__main__":
    main()
