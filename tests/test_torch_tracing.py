"""The program's spans (``squeezedet_torch/utils/profiling.span``): the
host ranges ``squeezedet.<name>`` a profiler records around the scoring
call's and the train step's phases, in order; nothing entered and no
marker enqueued without a profiler; ResNet50's stage spans inside its
backbone's; the marker kernels' names and order in
``csrc/conv1_pool1.cu``, each span's markers where they stood; and, on
the card (``cuda``-marked), a captured dispatch whose traced replay
holds each step's marker pairs in order while the kernels' ``LAUNCHES``
count no marker."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_threads import one_thread  # noqa: F401  (autouse)

import squeezedet_torch as st
from squeezedet_torch.optim import build_optimizer
from squeezedet_torch.trainer import TrainState, make_train_step_device_scan
from squeezedet_torch.utils import profiling

K = 2
SCORE_SPANS = ["ingest", "backbone", "interpret", "postprocess"]
TRAIN_SPANS = ["ingest", "matcher", "forward", "backward", "optimizer"]


def _dispatch_inputs(device, k=K, b=2, g=4, rows=5, seed=0):
    """(dataset, stacked inputs) of a device-dataset dispatch of k steps
    of batch b: canvas rows, augment rows and padded ground truth."""
    rng = np.random.RandomState(seed)
    dataset = rng.randint(0, 256, (rows, 110, 120, 3)).astype(np.uint8)
    pos = rng.randint(0, rows, (k, b)).astype(np.int32)
    dx, dy = rng.randint(-6, 7, (k, b)), rng.randint(-6, 7, (k, b))
    aug = np.stack([dx, dy, rng.randint(0, 2, (k, b)), 120 - dx, 110 - dy],
                   axis=-1).astype(np.float32)
    boxes = np.stack([rng.uniform(15, 80, (k, b, g)),
                      rng.uniform(15, 80, (k, b, g)),
                      rng.uniform(10, 40, (k, b, g)),
                      rng.uniform(10, 40, (k, b, g))],
                     axis=-1).astype(np.float32)
    labels = rng.randint(0, 3, (k, b, g)).astype(np.int32)
    num_gt = rng.randint(1, g + 1, (k, b)).astype(np.int32)
    return (torch.from_numpy(dataset).to(device),
            [torch.from_numpy(a) for a in (pos, aug, boxes, labels, num_gt)])


def _scan(device):
    det = st.get_model("squeezeDet", st.tiny_test_config(), device=device)
    return make_train_step_device_scan(
        TrainState(det, build_optimizer(det.cfg, det)), K,
        uint8_ingest=True, device_augment=True, device_dataset=True)


def _ranges(prof):
    """The program's host ranges in the trace (not their copies on the
    device's timeline), by start, without their prefix."""
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.PREFIX)
              and str(e.device_type()).endswith("CPU")]
    return [e.name()[len(profiling.PREFIX):]
            for e in sorted(events, key=lambda e: e.start_ns())]


@pytest.fixture(scope="module")
def detector():
    return st.get_model("squeezeDet", st.tiny_test_config(), device="cpu")


def test_scoring_call_shows_the_four_score_spans_in_order(detector):
    u8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 96, 96, 3)).astype(np.uint8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detector.predict_raw_postprocessed(u8)
    assert _ranges(prof) == SCORE_SPANS


def test_scan_dispatch_shows_the_train_spans_k_times_in_order():
    """A K = 2 dispatch on the CPU runs its steps eagerly, one after
    another: each step's five phases once, in order (the host-only
    dispatch spans belong to the captured path)."""
    scan = _scan("cpu")
    dataset, stacked = _dispatch_inputs("cpu")
    generator = torch.Generator().manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lb = scan(dataset, *stacked, generator=generator)
    assert lb.total.shape == (K,) and torch.isfinite(lb.total).all()
    assert _ranges(prof) == TRAIN_SPANS * K


def test_no_profiler_enters_no_range_and_enqueues_no_marker(
        detector, monkeypatch):
    """Without a profiler the scoring call and a dispatch open no
    ``record_function`` and launch no marker."""
    def refuse(name):
        raise AssertionError("record_function({!r}) entered".format(name))
    marks = []
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_mark",
                        lambda index, device: marks.append(index))
    detector.predict_raw_postprocessed(torch.zeros((2, 96, 96, 3),
                                                   dtype=torch.uint8))
    dataset, stacked = _dispatch_inputs("cpu")
    _scan("cpu")(dataset, *stacked, generator=torch.Generator())
    assert marks == []


@pytest.mark.parametrize("recording,capturing,marks", [
    (False, False, []),
    (True, False, [2, 3]),
    (False, True, [2, 3]),
    (True, True, [2, 3]),
], ids=["eager", "eager-profiled", "captured", "captured-profiled"])
def test_device_span_marks_when_profiled_or_captured(
        monkeypatch, recording, capturing, marks):
    """On a CUDA device the ``matcher`` span (markers 2 and 3) enqueues
    its pair while a profiler records or the stream is captured, and
    nothing otherwise; a host-only span never does.  The flags and the
    launch are stood in for here, where there is no card."""
    entered, launched = [], []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            entered.append("/" + self.name)

    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        recording)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(profiling, "_mark",
                        lambda index, device: launched.append(index))
    with profiling.span("matcher", torch.device("cuda")):
        launched.append("work")
    with profiling.span("dispatch.replay"):
        pass
    assert launched == marks[:1] + ["work"] + marks[1:]
    assert entered == (["squeezedet.matcher", "/squeezedet.matcher",
                        "squeezedet.dispatch.replay",
                        "/squeezedet.dispatch.replay"] if recording else [])


def test_device_span_names_a_known_phase():
    with pytest.raises(ValueError, match="not a device span"):
        profiling.span("dispatch.replay", torch.device("cuda"))


def test_marker_kernels_follow_device_spans():
    """The C source's marker list (built with K1) is DEVICE_SPANS, in
    order: marker 2 i begins span i."""
    source = (Path(profiling.__file__).parent.parent / "csrc" /
              "conv1_pool1.cu").read_text()
    body = re.search(r"#define SDT_SPANS\(X\)(.*?)\n#define", source,
                     re.S).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", body)) == profiling.DEVICE_SPANS


# the device spans as they stood before ResNet50's stages were added: a
# marker's index is its place in the C source's list, which only grows
FIRST_SPANS = ("ingest", "matcher", "forward", "backward", "optimizer",
               "backbone", "interpret", "postprocess")
STAGES = ["res2", "res3", "res4"]


@pytest.fixture(scope="module")
def resnet():
    from squeezedet_torch.config.kitti import custom_kitti_config
    return st.get_model("resnet50", custom_kitti_config("resnet50", 96, 64),
                        device="cpu")


def test_resnet_stage_spans_lie_inside_the_backbone_in_order(resnet):
    """A ResNet50 scoring call while a profiler records: the ranges
    ``squeezedet.res2``, ``.res3`` and ``.res4`` once each, in order, each
    inside ``squeezedet.backbone``."""
    u8 = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 64, 96, 3)).astype(np.uint8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        resnet.predict_raw_postprocessed(u8)
    assert _ranges(prof) == SCORE_SPANS[:2] + STAGES + SCORE_SPANS[2:]
    spans = {e.name()[len(profiling.PREFIX):]: (e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profiling.PREFIX)
             and str(e.device_type()).endswith("CPU")}
    lo, hi = spans["backbone"]
    bounds = [spans[n] for n in STAGES]
    assert lo <= bounds[0][0] and bounds[-1][1] <= hi
    assert all(a[1] <= b[0] for a, b in zip(bounds, bounds[1:]))


def test_resnet_without_profiler_enqueues_no_marker(resnet, monkeypatch):
    def refuse(name):
        raise AssertionError("record_function({!r}) entered".format(name))
    marks = []
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_mark",
                        lambda index, device: marks.append(index))
    resnet.predict_raw_postprocessed(torch.zeros((2, 64, 96, 3),
                                                 dtype=torch.uint8))
    assert marks == []


@pytest.mark.parametrize("name", FIRST_SPANS + tuple(STAGES))
def test_device_spans_keep_their_marker_indices(monkeypatch, name):
    """The first eight spans keep markers 2 i and 2 i + 1; the stages
    follow them.  A captured span of each enqueues its own pair (the
    capture and the launch stood in for)."""
    assert profiling.DEVICE_SPANS[:len(FIRST_SPANS)] == FIRST_SPANS
    assert profiling.DEVICE_SPANS[len(FIRST_SPANS):] == tuple(STAGES)
    i = profiling.DEVICE_SPANS.index(name)
    launched = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(profiling, "_mark",
                        lambda index, device: launched.append(index))
    with profiling.span(name, torch.device("cuda")):
        pass
    assert launched == [2 * i, 2 * i + 1]


@pytest.mark.cuda
def test_captured_replay_holds_each_steps_markers_in_order():
    """A captured K = 2 dispatch on the card: its traced replay holds
    each step's five marker pairs once, in order, between the dispatch's
    stage and replay ranges; K1's ``LAUNCHES`` gain K a replay, as many
    as the trace's K1 kernels, so no marker counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from squeezedet_torch.ops import fused_frontend
    scan = _scan("cuda")
    dataset, stacked = _dispatch_inputs("cuda")
    generator = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):  # the eager dispatch, then the capture and a replay
        scan(dataset, *stacked, generator=generator)
    torch.cuda.synchronize()
    before = fused_frontend.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan(dataset, *stacked, generator=generator)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.profiler.kineto_results.events()
                      if str(e.device_type()).endswith("CUDA")),
                     key=lambda e: e.start_ns())
    markers = [e.name() for e in kernels
               if e.name().startswith("squeezedet_span_")]
    assert markers == ["squeezedet_span_{}_{}".format(n, end)
                       for n in TRAIN_SPANS for end in ("begin", "end")] * K
    k1 = sum("conv1_pool1" in e.name() for e in kernels)
    assert fused_frontend.LAUNCHES - before == K == k1
    assert _ranges(prof) == ["dispatch.stage", "dispatch.replay"]
