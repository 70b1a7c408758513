"""Where the train CLI's host time goes, on one CUDA device.

    python -m squeezedet_torch.profile_train_loop [--images 48] [--steps 25]

Writes a KITTI tree of 1242x375 PNG frames (``data/synth.py``, libpng's
adaptive row filters) under ``--work`` and prints, each line beside the
card's name and power limit:

1. the decode ms per frame by OpenCV (where it imports) and by
   ``data/png.py``, and the frames' row-filter mix;
2. the canvas feed alone: ms per batch that ``PrefetchLoader`` delivers
   with nothing training, decoding with each;
3. the upload of one canvas batch to the card from pageable and from
   pinned memory;
4. the train CLI at B=20, 1248x384, bf16, ``--device_assign
   --uint8_ingest --device_augment --pallas_grads``: the mean and median
   interval between step calls and the intervals over twice the median,
   in four runs: summaries off (``--summary_step 0``); summaries every 10
   steps with the detection images (the CLI's default); the same with
   the image event dropped (the writer's ``image`` a no-op, so the
   scalars and the drawing remain); and summaries off with
   ``--image_cache_mb``, timed once every frame is decoded;
5. the summary step's parts: the host ms of the detection-image call,
   the image event's bytes (the event file's growth over the run without
   it), and the ms of tensorboard's masked CRC32C over that many bytes,
   which its record writer computes for every event.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from squeezedet_torch import train as cli
from squeezedet_torch import trainer
from squeezedet_torch.data import imdb as imdb_mod
from squeezedet_torch.data import png
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.data.synth import write_kitti_fixture
from squeezedet_torch.loader import PrefetchLoader
from squeezedet_torch.summary import SummaryWriter

FRAME = (375, 1242)  # (H, W) of a KITTI frame
ARGV = ["--device", "cuda", "--image_width", "1248", "--image_height", "384",
        "--batch_size", "20", "--compute_dtype", "bfloat16",
        "--learning_rate", "0.001", "--device_assign", "--uint8_ingest",
        "--device_augment", "--pallas_grads", "--checkpoint_step", "1000"]
FEED_WARMUP = 6  # batches that drain the loader's prefilled queue


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work", default=os.path.join(".chipscratch",
                                                  "profile_train_loop"),
                   help="scratch directory, removed at the end")
    p.add_argument("--images", type=int, default=48)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--timed_from", type=int, default=2,
                   help="steps of each run left out of its intervals")
    p.add_argument("--feed_batches", type=int, default=10)
    return p


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def _decoders():
    """(name, the data layer's OpenCV lookup) of each decoder here."""
    out = [("data/png.py", lambda: None)]
    if imdb_mod._opencv() is not None:
        out.insert(0, ("OpenCV", imdb_mod._opencv))
    return out


def decode_ms(paths):
    mix = np.bincount(np.concatenate([png.row_filters(p) for p in paths]),
                      minlength=5)
    out = {}
    for name, lookup in _decoders():
        with _patched(imdb_mod, "_opencv", lookup):
            t0 = time.perf_counter()
            for p in paths:
                imdb_mod.read_frame(p)
            out[name] = (time.perf_counter() - t0) * 1e3 / len(paths)
    return out, mix.tolist()


def feed_ms(root, cfg, batches):
    """ms per batch of the canvas feed alone, by decoder, after the
    prefetch queue's first fill; and one batch's canvas."""
    out = {}
    for name, lookup in _decoders():
        with _patched(imdb_mod, "_opencv", lookup):
            db = Kitti("train", root, cfg, rng=np.random.RandomState(0))
            loader = PrefetchLoader(db, device_targets=True,
                                    uint8_images=True, device_augment=True,
                                    max_gt=48).start()
            try:
                for _ in range(FEED_WARMUP):
                    loader.get(timeout=600)
                t0 = time.perf_counter()
                for _ in range(batches):
                    canvas = loader.get(timeout=600)[0]
                out[name] = (time.perf_counter() - t0) * 1e3 / batches
            finally:
                loader.stop()
    return out, canvas


def upload_ms(canvas, reps=5):
    src = torch.from_numpy(canvas)
    out = {}
    for name, host in (("pageable", src), ("pinned", src.pin_memory())):
        host.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            host.to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def run_cli(root, train_dir, steps, timed_from, *extra):
    """One train-CLI run: its step intervals, the host ms of each
    detection-image call and the event file's bytes."""
    calls, viz = [], []
    real_make, real_viz = (trainer.make_train_step_device,
                           trainer.viz_prediction_images)

    def timed_make(*args, **kwargs):
        fn = real_make(*args, **kwargs)

        def step(*a, **k):
            calls.append(time.perf_counter())
            return fn(*a, **k)
        return step

    def timed_viz(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_viz(*args, **kwargs)
        viz.append((time.perf_counter() - t0) * 1e3)
        return out

    with _patched(trainer, "make_train_step_device", timed_make), \
            _patched(trainer, "viz_prediction_images", timed_viz), \
            contextlib.redirect_stdout(io.StringIO()):
        cli.main(ARGV + ["--data_path", root, "--train_dir", train_dir,
                         "--max_steps", str(steps)] + list(extra))
    gaps = np.diff(calls[timed_from:]) * 1e3
    median = float(np.median(gaps))
    events = sum(os.path.getsize(os.path.join(train_dir, n))
                 for n in os.listdir(train_dir)
                 if n.startswith("events.out.tfevents"))
    return {"mean": float(gaps.mean()), "median": median,
            "long": {timed_from + i: round(float(g), 1)
                     for i, g in enumerate(gaps) if g > 2 * median},
            "viz_ms": [round(v, 1) for v in viz], "event_bytes": events}


def crc_ms(nbytes):
    """tensorboard's masked CRC32C over ``nbytes`` random bytes."""
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
        masked_crc32c)
    data = os.urandom(nbytes)
    t0 = time.perf_counter()
    masked_crc32c(data)
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> None:
    args = build_arg_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_loop needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    shutil.rmtree(args.work, ignore_errors=True)
    root = os.path.join(args.work, "kitti")
    try:
        indices = write_kitti_fixture(root, args.images, FRAME)
        paths = [os.path.join(root, "training", "image_2", i + ".png")
                 for i in indices]
        dec, mix = decode_ms(paths)
        print("decode ms per {}x{} frame over {} frames: {}; rows by filter "
              "none/Sub/Up/Avg/Paeth {}; on the host of {}".format(
                  FRAME[1], FRAME[0], len(paths),
                  {k: round(v, 3) for k, v in dec.items()}, mix, card),
              flush=True)
        cfg = cli.config_from_args(cli.build_arg_parser().parse_args(ARGV))
        feed, canvas = feed_ms(root, cfg, args.feed_batches)
        print("canvas feed alone (PrefetchLoader, {} threads, B={}, nothing "
              "training), ms/batch over {} batches: {}; on the host of "
              "{}".format(cfg.num_thread, cfg.batch_size, args.feed_batches,
                          {k: round(v, 3) for k, v in feed.items()}, card),
              flush=True)
        up = upload_ms(canvas)
        print("upload of one {:.1f} MB canvas batch: {}; on {}".format(
            canvas.nbytes / 1e6, {k: round(v, 3) for k, v in up.items()},
            card), flush=True)

        probe = SummaryWriter(os.path.join(args.work, "probe"))
        writer_on = probe.enabled
        probe.close()
        runs = {}
        for name, extra, timed_from in (
                ("summaries off", ["--summary_step", "0"], args.timed_from),
                ("summaries + images", ["--summary_step", "10"],
                 args.timed_from),
                ("summaries, image event dropped", ["--summary_step", "10"],
                 args.timed_from),
                ("summaries off, frames cached",
                 ["--summary_step", "0", "--image_cache_mb", "256"],
                 max(args.timed_from, 6))):
            train_dir = os.path.join(args.work, name.replace(" ", "_")
                                     .replace(",", "").replace("+", "and"))
            if name == "summaries, image event dropped":
                with _patched(SummaryWriter, "image",
                              lambda *a, **k: None):
                    r = run_cli(root, train_dir, args.steps, timed_from,
                                *extra)
            else:
                r = run_cli(root, train_dir, args.steps, timed_from, *extra)
            runs[name] = r
            print("train CLI, {} (steps {}..{}): mean {:.3f} ms/step, median "
                  "{:.3f}, intervals over twice the median by the step "
                  "before them {}; detection-image calls {} ms; event file "
                  "{} bytes; summary writer enabled: {}; on {}".format(
                      name, timed_from, args.steps - 1, r["mean"],
                      r["median"], r["long"], r["viz_ms"], r["event_bytes"],
                      writer_on, card), flush=True)
        with_images = runs["summaries + images"]
        summaries = len(with_images["viz_ms"])
        if writer_on and summaries:
            per_event = (with_images["event_bytes"] - runs[
                "summaries, image event dropped"]["event_bytes"]) \
                // summaries
            print("image event: {} bytes per summary step; tensorboard's "
                  "masked CRC32C over that many bytes: {:.1f} ms; on the "
                  "host of {}".format(per_event, crc_ms(per_event), card),
                  flush=True)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)


if __name__ == "__main__":
    main()
