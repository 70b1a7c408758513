"""The port's HTTP server and micro-batcher on the CPU device, serving
saved checkpoints, and the port's import boundary."""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

import torch

import squeezedet_torch as st
from squeezedet_torch import serve

REPO = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture
def server():
    args = serve.build_arg_parser().parse_args(
        ["--device", "cpu", "--port", "0", "--compute_dtype", "float32",
         "--prob_thresh", "0"])
    srv, batcher = serve.build_server(args, st.tiny_test_config())
    assert batcher is None  # --max_batch 1: serial server
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield "http://127.0.0.1:{}".format(srv.server_address[1])
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        assert r.status == 200 and r.read() == b"ok"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope", timeout=30)
    assert e.value.code == 404


def test_detect_png(server):
    """A differently-sized PNG: the server resizes and scales boxes back."""
    im = np.random.RandomState(0).randint(0, 255, (48, 192, 3), np.uint8)
    png = cv2.imencode(".png", im)[1].tobytes()
    req = urllib.request.Request(server + "/detect", data=png, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        payload = json.loads(r.read())
    assert "latency_ms" in payload
    assert 0 < len(payload["detections"]) <= 64
    for d in payload["detections"]:
        assert set(d) == {"box", "score", "class_name"}
        assert d["class_name"] in st.tiny_test_config().class_names
        assert len(d["box"]) == 4 and all(np.isfinite(d["box"]))
    bad = urllib.request.Request(server + "/detect", data=b"not an image",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(bad, timeout=30)
    assert e.value.code == 400


def test_micro_batcher_groups_concurrent_requests():
    """8 concurrent submits at batch 4 run as 2+ padded batches, and each
    caller gets back its own row."""
    seen = []

    def run(imgs):
        seen.append(imgs.shape[0])
        time.sleep(0.05)
        ids = imgs[:, 0, 0, 0].astype(np.float32)
        return ids[:, None], ids[:, None] > 0

    batcher = serve.MicroBatcher(run, batch=4, window_ms=50.0)
    frames = [np.full((2, 2, 3), i, np.uint8) for i in range(8)]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(batcher.submit, frames))
    assert all(s == 4 for s in seen)
    assert 2 <= batcher.batches_run < 8 and batcher.requests == 8
    for i, (ids, _) in enumerate(outs):
        assert ids.shape == (1, 1) and ids[0, 0] == i


def test_micro_batcher_p99_bound_at_realistic_service_time():
    """The serving tail-latency invariant of the JAX package's server
    (tests/test_serve.py), on the port's MicroBatcher with the same stub
    service time, geometry and bound: with reject-on-overload, every
    ACCEPTED request's latency is bounded by the queue geometry,
        p99_accepted <= (max_queue/max_batch + 1) x (service + window)
    times a 2x scheduler-jitter tolerance, whatever the offered load, and
    the excess is shed as Overloaded.  A stub run_batched sleeps 25 ms (a
    batch-8 program on a PCIe host); 96 clients x 3 rounds offer about 3x
    the capacity while a round's burst is in flight."""
    service_s = 0.025
    batch, max_queue, window_ms = 8, 16, 2.0

    def run_batched(imgs):
        time.sleep(service_s)  # stand-in for the device program
        n = imgs.shape[0]
        z = np.zeros((n, 4), np.float32)
        return np.zeros((n, 4, 4), np.float32), z, z, z

    b = serve.MicroBatcher(run_batched, batch=batch, window_ms=window_ms,
                           max_queue=max_queue)
    lat_accepted, rejected = [], [0]
    lock = threading.Lock()

    def client(rounds):
        for _ in range(rounds):
            t0 = time.perf_counter()
            try:
                b.submit(np.zeros((2, 2, 3), np.uint8))
            except serve.Overloaded:
                with lock:
                    rejected[0] += 1
                continue
            dt = time.perf_counter() - t0
            with lock:
                lat_accepted.append(dt)

    threads = [threading.Thread(target=client, args=(3,))
               for _ in range(96)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)

    assert len(lat_accepted) + rejected[0] == 288
    assert b.requests == len(lat_accepted)
    assert b.rejects == rejected[0]
    assert rejected[0] > 0  # overload must shed: the queue bound is live
    assert len(lat_accepted) >= 50  # enough samples for a p99
    bound = (max_queue / batch + 1) * (service_s + window_ms / 1000.0)
    p99 = float(np.percentile(np.asarray(lat_accepted), 99))
    assert p99 <= 2.0 * bound, (
        "accepted p99 {:.3f}s exceeds 2x the queue-geometry bound "
        "{:.3f}s".format(p99, bound))


def test_micro_batcher_rejects_and_propagates_errors():
    def boom(imgs):
        raise ValueError("device fault")

    batcher = serve.MicroBatcher(boom, batch=2, window_ms=1.0)
    with pytest.raises(ValueError, match="device fault"):
        batcher.submit(np.zeros((2, 2, 3), np.uint8))
    full = serve.MicroBatcher(lambda x: (x,), batch=2, window_ms=1.0,
                              max_queue=1)
    with full._cv:  # hold the worker off so the queue stays full
        full._pending.append((np.zeros((1,)), {}, threading.Event()))
        with pytest.raises(serve.Overloaded):
            full.submit(np.zeros((1,)))
    assert full.rejects == 1


@pytest.mark.parametrize("flag", [["--num_devices", "2", "--max_batch",
                                   "3"]])
def test_unported_options_name_their_roadmap_item(flag):
    """--num_devices is ported (test_torch_parallel.py serves over two
    replicas); like the JAX server it refuses a micro-batch that does not
    split over the replicas."""
    args = serve.build_arg_parser().parse_args(["--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="not divisible"):
        serve.build_server(args, st.tiny_test_config())


@pytest.mark.parametrize("source", ["checkpoint_dir", "caffe_pickle"])
def test_serves_a_saved_checkpoint(source, tmp_path):
    """``--checkpoint`` serves the saved weights: the server's program
    returns what ``predict_raw_postprocessed`` gives with them."""
    import pickle

    from squeezedet_torch.checkpoint.manager import CheckpointManager
    from squeezedet_torch.weights import pickle_from_jax_params, \
        to_jax_params
    cfg = st.tiny_test_config().replace(batch_size=2)
    det = st.get_model("squeezeDet", cfg, device="cpu",
                       generator=torch.Generator().manual_seed(7))
    with torch.no_grad():  # spread the scores of the 1e-4 head
        det.backbone.conv12.weight.mul_(500.0)
    if source == "checkpoint_dir":
        path = str(tmp_path / "train")
        CheckpointManager(path).save(9, {"params":
                                         det.backbone.state_dict()})
    else:
        path = str(tmp_path / "weights.pkl")
        with open(path, "wb") as f:
            pickle.dump(pickle_from_jax_params(to_jax_params(
                det.backbone.state_dict())), f)
    args = serve.build_arg_parser().parse_args(
        ["--device", "cpu", "--compute_dtype", "float32", "--max_batch", "2",
         "--checkpoint", path])
    run, _ = serve._build_from_checkpoint(args, cfg)
    u8 = np.random.RandomState(3).randint(0, 256, (2, 96, 96, 3), np.uint8)
    got = run(u8)
    want = det.predict_raw_postprocessed(torch.from_numpy(u8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert got[3].any()


def test_cuda_without_cuda_exits():
    args = serve.build_arg_parser().parse_args(["--checkpoint", "none"])
    assert args.device == "cuda" and not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.build_server(args, st.tiny_test_config())


def test_port_imports_no_jax():
    """squeezedet_torch, its entry points and its data layer import
    neither jax nor the JAX package (whose __init__ imports jax), nor cv2
    at import time."""
    code = ("import sys; import squeezedet_torch, squeezedet_torch.serve, "
            "squeezedet_torch.weights, squeezedet_torch.ops.fused_frontend, "
            "squeezedet_torch.eval, squeezedet_torch.demo, "
            "squeezedet_torch.data.kitti, squeezedet_torch.data.kitti_ap, "
            "squeezedet_torch.data.pascal_voc, squeezedet_torch.native, "
            "squeezedet_torch.utils.plots, squeezedet_torch.train, "
            "squeezedet_torch.models.squeezedet_plus, "
            "squeezedet_torch.models.vgg16, "
            "squeezedet_torch.models.resnet50, "
            "squeezedet_torch.config.voc, squeezedet_torch.quant, "
            "squeezedet_torch.serving, squeezedet_torch.export, "
            "squeezedet_torch.tools.quant_report; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'squeezedet_tpu', 'cv2')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
