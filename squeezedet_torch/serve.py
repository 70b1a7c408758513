"""``squeezedet-torch-serve``: a minimal stdlib HTTP detection service
(counterpart of ``squeezedet_tpu/serve.py``).

Builds the uint8 -> detections program once on ``--device`` (``cuda``
by default, never falling back to the CPU), warms it, and answers

    POST /detect      body = image bytes (png/jpeg)
                      -> JSON {detections: [{box: [cx, cy, w, h],
                         score, class_name}, ...], latency_ms}
    GET  /healthz     -> 200 'ok' once the model is warm

By default requests are handled serially.  ``--max_batch N`` switches to
a threading server with a micro-batcher: concurrent requests that arrive
within ``--batch_window_ms`` of each other are padded into one batch-N
forward.

``--checkpoint`` serves a port checkpoint directory (its newest step)
or a caffe pickle, loaded as the demo loads them; without it the weights
are seeded random.  ``--quantize int8`` serves the int8 program of those
weights, calibrated on ``--calib_images`` (``quant.py``).  ``--artifact``
serves an exported artifact (``squeezedet-torch-export``) instead, with
no model code, on the device it was traced on.  ``--num_devices N`` serves
each micro-batch over N replicas of the checkpoint's model, each on its
``max_batch / N`` rows (``serving.mesh_inference_fn``); 0 takes every
visible device.  An artifact is one device's program.
"""

from __future__ import annotations

import argparse
import json
import threading
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve squeezedet-torch detections over HTTP.")
    p.add_argument('--checkpoint', default='',
                   help='Checkpoint directory of the port (its newest '
                        'model.ckpt-<step>) or a caffe .pkl weight file.')
    p.add_argument('--artifact', default='',
                   help='squeezedet-torch-export artifact directory '
                        '(instead of --checkpoint; runs without the model '
                        'code, on the kind of device it was traced on).')
    p.add_argument('--net', default='squeezeDet')
    p.add_argument('--device', default='cuda',
                   help='torch device to serve on; never falls back.')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8752)
    p.add_argument('--compute_dtype', default='bfloat16',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--prob_thresh', type=float, default=None,
                   help='Report only detections above this score '
                        '(default: the config plot threshold).')
    p.add_argument('--quantize', default='', choices=['', 'int8'],
                   help='Serve the int8 PTQ program (quant.py); requires '
                        '--calib_images.')
    p.add_argument('--calib_images', default='',
                   help='Image file, directory or glob for --quantize '
                        'calibration (representative frames).')
    p.add_argument('--calib_percentile', type=float, default=None,
                   help='Calibrate activation ranges at this percentile of '
                        '|activation| instead of abs-max (saturating clip, '
                        'e.g. 99.99).')
    p.add_argument('--max_batch', type=int, default=1,
                   help='Micro-batching: run the program at this batch '
                        'size behind a threading server, folding '
                        'concurrent requests into one forward.')
    p.add_argument('--batch_window_ms', type=float, default=2.0,
                   help='How long the micro-batcher waits for more '
                        'requests after the first of a batch arrives.')
    p.add_argument('--num_devices', type=int, default=1,
                   help='Data-parallel serving: 1 (default) serves on one '
                        'device; N>1 runs each micro-batch over N replicas '
                        '(--max_batch divisible by N; more replicas than '
                        'cards share them); 0 uses every visible device. '
                        'Checkpoint-backed only: an artifact is one '
                        "device's program.")
    p.add_argument('--max_queue', type=int, default=None,
                   help='Reject /detect with 503 when this many '
                        'requests are already queued for the '
                        'micro-batcher. Default: 4x max_batch; 0 disables.')
    return p


class Overloaded(RuntimeError):
    """The micro-batch queue is at its limit; the caller should shed the
    request (HTTP 503) instead of parking another handler thread."""


class MicroBatcher:
    """Folds concurrent single-image requests into one batched forward.

    ``run_batched`` takes a [N, H, W, 3] uint8 array and returns the
    postprocessed (boxes, probs, classes, keep) arrays; ``submit(im)``
    blocks the calling handler thread until its image's row is back.
    Partial batches are padded with the first image (results of pad rows
    are dropped), so the program always runs at one batch size.

    ``max_queue`` bounds the number of not-yet-grouped requests: beyond
    it, ``submit`` raises :class:`Overloaded` immediately.  0 = unbounded.
    """

    def __init__(self, run_batched, batch: int, window_ms: float,
                 max_queue: int = 0):
        self._run = run_batched
        self.batch = batch
        self.window = window_ms / 1000.0
        self.max_queue = max_queue
        self._cv = threading.Condition()
        self._pending = []  # [(image, slot dict, event)]
        self.batches_run = 0
        self.requests = 0
        self.rejects = 0
        t = threading.Thread(target=self._worker, daemon=True)
        t.start()

    def submit(self, im):
        ev = threading.Event()
        slot = {}
        with self._cv:
            if self.max_queue and len(self._pending) >= self.max_queue:
                self.rejects += 1
                raise Overloaded(
                    "micro-batch queue full ({} pending)".format(
                        len(self._pending)))
            self._pending.append((im, slot, ev))
            self.requests += 1
            self._cv.notify_all()
        if not ev.wait(timeout=120.0):
            raise TimeoutError("micro-batch worker stalled")
        if "error" in slot:
            raise slot["error"]
        return slot["out"]

    def _worker(self):
        import numpy as np
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                deadline = time.monotonic() + self.window
                while len(self._pending) < self.batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        break
                group = self._pending[:self.batch]
                del self._pending[:len(group)]
            imgs = np.stack([g[0] for g in group] +
                            [group[0][0]] * (self.batch - len(group)))
            try:
                outs = [np.asarray(o) for o in self._run(imgs)]
                for i, (_, slot, ev) in enumerate(group):
                    slot["out"] = tuple(o[i:i + 1] for o in outs)
                    ev.set()
            except Exception as e:  # surface to every waiting handler
                for _, slot, ev in group:
                    slot["error"] = e
                    ev.set()
            self.batches_run += 1


def _resolve_num_devices(args, device) -> int:
    """0 -> every visible device; the micro-batch must divide over the
    replicas."""
    from squeezedet_torch.parallel.mesh import visible_devices
    n = args.num_devices or visible_devices(device)
    if n > 1 and args.max_batch % n:
        raise SystemExit(
            "--max_batch {} is not divisible by --num_devices {}: the "
            "micro-batch splits evenly over the replicas".format(
                args.max_batch, n))
    return n


def _reject_unported(args) -> None:
    """The combinations the JAX server refuses."""
    if args.artifact and args.quantize:
        raise SystemExit(
            "--quantize does not apply to --artifact (an artifact bakes its "
            "program in at export time): build an int8 artifact with "
            "squeezedet-torch-export --quantize int8")
    if args.quantize and not args.calib_images:
        raise SystemExit("--quantize needs --calib_images")


def _build_from_checkpoint(args, cfg=None):
    """(run, meta) for the model of ``args.checkpoint`` (seeded random
    weights without one) on ``args.device``, int8 with ``--quantize``.

    ``run`` maps a uint8 [max_batch, H, W, 3] numpy batch to numpy
    (boxes, probs, classes, keep).  ``cfg`` overrides the net's canonical
    config (tests serve a tiny geometry).
    """
    from squeezedet_torch.config import config_for_net
    from squeezedet_torch.models import get_model
    from squeezedet_torch.parallel.mesh import make_mesh
    from squeezedet_torch.serving import mesh_inference_fn
    from squeezedet_torch.utils.util import resolve_device

    _reject_unported(args)
    device = resolve_device(args.device, "the server")
    n_dev = _resolve_num_devices(args, device)
    cfg = (cfg or config_for_net(args.net)).replace(
        batch_size=args.max_batch, load_pretrained_model=False,
        compute_dtype=args.compute_dtype)
    det = get_model(args.net, cfg, device=device)
    if args.checkpoint:
        from squeezedet_torch.demo import load_params
        load_params(det, args.checkpoint)
    else:
        print("WARNING: no --checkpoint/--artifact; serving random init")
    if args.quantize:
        from squeezedet_torch.quant import calib_batch_from_images
        calib = calib_batch_from_images(
            args.calib_images, cfg.image_width, cfg.image_height)
        print("Quantizing (int8 PTQ, {} calibration frames)...".format(
            len(calib)))
        det = det.quantize([calib], percentile=args.calib_percentile)
    meta = {"class_names": list(cfg.class_names),
            "image_height": cfg.image_height,
            "image_width": cfg.image_width,
            "plot_prob_thresh": cfg.plot_prob_thresh}
    mesh = make_mesh(n_dev, device)
    if n_dev > 1:
        print("serving mesh: {} replicas x batch {} ({} rows each) on "
              "{}".format(n_dev, args.max_batch, args.max_batch // n_dev,
                          ", ".join(str(d) for d in mesh)))
    return mesh_inference_fn(det, args.max_batch, mesh), meta


def _build_from_artifact(args):
    """(run, meta) for the artifact at ``args.artifact``, as
    :func:`_build_from_checkpoint` gives them, on ``args.device`` (which
    must be of the kind the artifact was traced on).  Refuses an artifact
    that does not fit the server: raw outputs, float input, or another
    batch than ``--max_batch``."""
    from squeezedet_torch.serving import load_exported
    from squeezedet_torch.utils.util import resolve_device

    _reject_unported(args)
    if _resolve_num_devices(args, args.device) > 1:
        raise SystemExit(
            "--num_devices > 1 needs --checkpoint: an exported artifact is "
            "one device's program; serve the checkpoint for data-parallel "
            "serving")
    fn, meta = load_exported(args.artifact,
                             resolve_device(args.device, "the server"))
    if not meta.get("postprocess", True):
        raise SystemExit("artifact was exported with --no_postprocess; the "
                         "server needs the postprocessed outputs")
    if meta.get("input_dtype", "uint8") != "uint8":
        raise SystemExit("artifact takes {} input; the server sends raw "
                         "uint8 frames: export it again without "
                         "--f32_input".format(meta["input_dtype"]))
    if meta.get("batch_size", 1) != args.max_batch:
        raise SystemExit("artifact was exported at batch_size={}; the server "
                         "runs the program at batch {}: export it again "
                         "with a matching --batch_size or pass --max_batch "
                         "{}".format(meta["batch_size"], args.max_batch,
                                     meta["batch_size"]))

    def run(images_u8):
        return tuple(o.cpu().numpy() for o in fn(images_u8))

    return run, meta


def make_handler(run, meta, prob_thresh):
    """Build the request handler around a warm inference callable."""
    import http.server

    import numpy as np

    h, w = meta["image_height"], meta["image_width"]
    names = meta["class_names"]

    class Handler(http.server.BaseHTTPRequestHandler):
        def _reply(self, code, body, ctype="application/json",
                   headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, b"ok", "text/plain")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            import cv2  # only the image decode needs it
            if self.path != "/detect":
                self._reply(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._reply(400, b'{"error": "bad Content-Length"}')
                return
            if length <= 0 or length > 64 * 1024 * 1024:
                self._reply(400, b'{"error": "body must be 1 byte to '
                                 b'64 MiB of image data"}')
                return
            raw = self.rfile.read(length)
            im = cv2.imdecode(np.frombuffer(raw, np.uint8),
                              cv2.IMREAD_COLOR)
            if im is None:
                self._reply(400, b'{"error": "undecodable image"}')
                return
            t0 = time.perf_counter()
            x_scale = im.shape[1] / float(w)
            y_scale = im.shape[0] / float(h)
            im = cv2.resize(im, (w, h))
            try:
                boxes, probs, classes, keep = [
                    np.asarray(o) for o in run(im[None])]
            except Overloaded:
                self._reply(503, b'{"error": "overloaded, retry later"}',
                            headers={"Retry-After": "1"})
                return
            dt = (time.perf_counter() - t0) * 1000
            dets = []
            for k in range(boxes.shape[1]):
                if not keep[0, k] or probs[0, k] < prob_thresh:
                    continue
                cx, cy, bw, bh = [float(v) for v in boxes[0, k]]
                dets.append({
                    "box": [cx * x_scale, cy * y_scale,
                            bw * x_scale, bh * y_scale],
                    "score": float(probs[0, k]),
                    "class_name": names[int(classes[0, k])],
                })
            self._reply(200, json.dumps(
                {"detections": dets,
                 "latency_ms": round(dt, 2)}).encode())

        def log_message(self, fmt, *a):  # quiet per-request chatter
            pass

    return Handler


def build_server(args, cfg=None):
    """Build and warm the model, then the HTTP server (not yet serving).

    Returns (server, batcher); ``batcher`` is the :class:`MicroBatcher`
    when ``--max_batch`` > 1, else None.
    """
    import http.server

    import numpy as np

    if args.max_batch < 1:
        raise SystemExit("--max_batch must be >= 1, got {}".format(
            args.max_batch))
    if args.artifact:
        run, meta = _build_from_artifact(args)
    else:
        run, meta = _build_from_checkpoint(args, cfg)
    prob_thresh = args.prob_thresh if args.prob_thresh is not None \
        else meta["plot_prob_thresh"]

    h, w = meta["image_height"], meta["image_width"]
    print("warming {}x{} program (batch {})...".format(h, w, args.max_batch))
    run(np.zeros((args.max_batch, h, w, 3), np.uint8))

    if args.max_batch == 1:
        return http.server.HTTPServer(
            (args.host, args.port), make_handler(run, meta, prob_thresh)), \
            None
    # concurrency path: handler threads park in the micro-batcher, which
    # folds them into one batch-N forward
    max_queue = args.max_queue if args.max_queue is not None \
        else 4 * args.max_batch
    batcher = MicroBatcher(run, args.max_batch, args.batch_window_ms,
                           max_queue=max_queue)
    handler = make_handler(lambda im1: batcher.submit(im1[0]), meta,
                           prob_thresh)

    # a deep listen queue lets a burst reach the app-level 503 policy
    # instead of being reset by the stdlib default backlog of 5
    class _Server(http.server.ThreadingHTTPServer):
        request_queue_size = 128

    return _Server((args.host, args.port), handler), batcher


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    server, _ = build_server(args)
    host, port = server.server_address[:2]
    print("serving on http://{}:{}  (POST /detect, GET /healthz)".format(
        host, port))
    server.serve_forever()


if __name__ == '__main__':
    main()
