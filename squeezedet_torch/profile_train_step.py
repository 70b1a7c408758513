"""Where the train step's device time goes, by kernel.

    python -m squeezedet_torch.profile_train_step --batch 20 \\
        --dtype bfloat16 --filter_grad 1x1
    python -m squeezedet_torch.profile_train_step --batch 128 \\
        --filter_grad false 1x1

Runs ``make_train_step_device`` (uint8 ingest, dropout on) at the
flagship 1248x384 squeezeDet with seeded random weights on one CUDA
device, times a few steps after warm-up (host clock, synchronised),
profiles as many again with ``torch.profiler``, and prints the wall time
per step and the device kernels grouped by name (kernel rows only: the
profiler also lists each kernel under its aten op, which would count it
twice), largest first.  The kernels' sum against the unprofiled wall
time gives the device's idle share.  Given two filter-grad modes, it
runs both on the same weights and batch and then prints the kernel rows
whose time or calls per step differ, the second mode minus the first.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from squeezedet_torch.config import kitti_squeezedet_config
from squeezedet_torch.models import get_model
from squeezedet_torch.models import layers as L
from squeezedet_torch.optim import build_optimizer
from squeezedet_torch.trainer import TrainState, make_train_step_device

_MODES = {"false": False, "1x1": "1x1", "true": True}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--filter_grad", default=["1x1"], nargs="+",
                   choices=sorted(_MODES),
                   help="one mode, or two to print their difference")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--rows", type=int, default=25)
    return p


def _profile(step, batch_args, args, mode):
    """(wall ms/step, ms/step under the profiler, {kernel: (ms/step,
    calls)}) of the train step in filter-grad ``mode``."""
    L.set_filter_grad(_MODES[mode])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(args.warmup):
        step(*batch_args, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(*batch_args, generator=gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(*batch_args, generator=gen)
        torch.cuda.synchronize()
        profiled = (time.perf_counter() - t0) / args.steps * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (
                ms + ev.time_range.elapsed_us() / 1e3 / args.steps, n + 1)
    return wall, profiled, kernels


def main(argv=None) -> None:
    args = build_arg_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a CUDA device")
    if len(args.filter_grad) > 2:
        raise SystemExit("--filter_grad takes one mode or two")
    cfg = kitti_squeezedet_config().replace(compute_dtype=args.dtype)
    det = get_model("squeezeDet", cfg, device="cuda")
    weights = {k: v.clone() for k, v in det.state_dict().items()}
    rs = np.random.RandomState(0)
    b, h, w = args.batch, cfg.image_height, cfg.image_width
    u8 = torch.from_numpy(rs.randint(0, 256, (b, h, w, 3),
                                     dtype=np.uint8)).cuda()
    bw, bh = rs.uniform(20, w / 4, (b, 48)), rs.uniform(20, h / 2, (b, 48))
    boxes = np.stack([rs.uniform(bw / 2, w - bw / 2),
                      rs.uniform(bh / 2, h - bh / 2), bw, bh], axis=-1)
    gt = [torch.from_numpy(a).cuda() for a in (
        boxes.astype(np.float32), rs.randint(0, cfg.classes, (b, 48)),
        rs.randint(1, 25, b))]
    runs = []
    for mode in args.filter_grad:
        det.load_state_dict(weights)  # every mode from the same weights
        step = make_train_step_device(
            TrainState(det, build_optimizer(cfg, det)), uint8_ingest=True)
        wall, profiled, kernels = _profile(step, (u8, *gt), args, mode)
        total = sum(ms for ms, _ in kernels.values())
        print("{} B={} {} filter_grad={}: wall {:.3f} ms/step ({:.3f} under "
              "the profiler), kernels {:.3f} ms/step, device idle {:.1f} % "
              "of the wall".format(torch.cuda.get_device_name(0), b,
                                   args.dtype, mode, wall, profiled, total,
                                   100.0 * (1.0 - total / wall)))
        print("| ms/step | share of wall | calls/step | kernel |")
        print("| --- | --- | --- | --- |")
        for name, (ms, n) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:args.rows]:
            print("| {:.3f} | {:.1f} % | {:g} | `{}` |".format(
                ms, 100.0 * ms / wall, n / args.steps, name[:110]))
        runs.append((mode, wall, total, kernels))
    if len(runs) == 2:
        (m0, w0, t0, k0), (m1, w1, t1, k1) = runs
        print("{} minus {}: wall {:+.3f} ms/step, kernels {:+.3f} ms/step; "
              "rows that differ, largest change first:".format(
                  m1, m0, w1 - w0, t1 - t0))
        print("| delta ms/step | delta calls/step | kernel |")
        print("| --- | --- | --- |")
        diff = {}
        for name in set(k0) | set(k1):
            (a, na), (c, nc) = k0.get(name, (0.0, 0)), k1.get(name, (0.0, 0))
            if na != nc or abs(c - a) >= 0.005:
                diff[name] = (c - a, (nc - na) / args.steps)
        for name, (dms, dn) in sorted(diff.items(),
                                      key=lambda kv: -abs(kv[1][0])
                                      )[:args.rows]:
            print("| {:+.3f} | {:+g} | `{}` |".format(dms, dn, name[:110]))


if __name__ == "__main__":
    main()
