"""The readers of the program's spans (``span_ms``, ``span_kernels``,
``host_ms``, ``span_idle``) on hand-built trace summaries: marker pairs,
a pair cut by the window's edge, kernels inside a pair, idle inside a
host range, nothing read where the program has no spans; and the
benchmark's 17 span entries resolving to them."""

from types import SimpleNamespace

import pytest

from portbench import run
from portbench.trace import Summary

MS = 1_000_000  # ns


def _marker(phase, end, start_ms, length_ms=0.001):
    name = "squeezedet_span_{}_{}".format(phase, "end" if end else "begin")
    s = int(start_ms * MS)
    return (name, s, s + int(length_ms * MS), "kernel")


def _kernel(start_ms, length_ms, name="k", kind="kernel"):
    s = int(start_ms * MS)
    return (name, s, s + int(length_ms * MS), kind)


def _ctx(device, host=(), window_s=0.02, steps=2, dispatches=1):
    return SimpleNamespace(
        trace=Summary(list(device), list(host), window_s, 1),
        window={"steps": steps, "dispatches": dispatches}, cfg={}, mix={})


def _read(metric, ctx):
    return run.reader(metric).read(ctx, metric)


# two steps' ingest phases: [1, 4] and [10, 12] ms between the markers'
# facing edges, with kernels, a copy and another phase's markers around
STEPS = [
    _marker("ingest", False, 0.999), _kernel(1.0, 1.0), _kernel(2.5, 0.5),
    _kernel(3.0, 0.2, "Memcpy HtoD", "copy"), _marker("ingest", True, 4.0),
    _marker("matcher", False, 5.0), _kernel(5.5, 1.0),
    _marker("matcher", True, 7.0),
    _marker("ingest", False, 9.999), _kernel(10.0, 1.0),
    _marker("ingest", True, 12.0),
]


def test_span_ms_sums_complete_pairs_over_steps():
    ctx = _ctx(STEPS)
    assert _read("span_ms.train.ingest", ctx) == pytest.approx((3 + 2) / 2)
    assert _read("span_ms.train.matcher", ctx) == pytest.approx(
        (7 - 5.001) / 2)
    assert _read("span_ms.score.backbone", ctx) is None


def test_a_pair_cut_by_the_windows_edge_is_dropped():
    """An end marker whose begin fell before the window, and a begin
    whose end falls after it, count for nothing."""
    cut = [_marker("ingest", True, 0.5), _kernel(0.1, 0.3)] + STEPS + [
        _marker("ingest", False, 15.0), _kernel(15.5, 1.0)]
    ctx = _ctx(cut)
    assert _read("span_ms.train.ingest", ctx) == pytest.approx((3 + 2) / 2)
    assert _read("span_kernels.train.ingest", ctx) == pytest.approx(3 / 2)


def test_span_kernels_counts_kernels_starting_inside_a_pair():
    """Kernels (not copies, not markers) that start between a pair's
    markers, over the steps."""
    ctx = _ctx(STEPS)
    assert _read("span_kernels.train.ingest", ctx) == pytest.approx(3 / 2)
    assert _read("span_kernels.train.matcher", ctx) == pytest.approx(1 / 2)
    assert _read("span_kernels.train.optimizer", ctx) is None


def test_host_ms_sums_the_dispatch_ranges_over_dispatches():
    host = [("squeezedet.dispatch.stage", 0, 2 * MS),
            ("squeezedet.dispatch.replay", 2 * MS, 9 * MS),
            ("cudaGraphLaunch", 3 * MS, 8 * MS),
            ("squeezedet.dispatch.stage", 10 * MS, 11 * MS),
            ("squeezedet.dispatch.replay", 11 * MS, 14 * MS)]
    ctx = _ctx([_kernel(0, 1)], host, dispatches=2)
    assert _read("host_ms.train.stage", ctx) == pytest.approx(1.5)
    assert _read("host_ms.train.replay", ctx) == pytest.approx(5.0)


def test_span_idle_is_the_idle_inside_the_host_range():
    """A 10 ms replay range over device work at [2, 5] and [4, 6] ms (a
    copy among it) is idle 6 ms of it: 30 % of a 20 ms window, within the
    window's whole idle share."""
    device = [_kernel(2, 3), _kernel(4, 2, "Memcpy DtoD", "copy"),
              _kernel(12, 4)]
    host = [("squeezedet.dispatch.replay", 0, 10 * MS),
            ("squeezedet.dispatch.stage", 10 * MS, 11 * MS)]
    ctx = _ctx(device, host, window_s=0.02)
    idle = _read("span_idle.train.replay", ctx)
    assert idle == pytest.approx(30.0)
    assert idle <= _read("device_idle.train", ctx)


def test_nothing_is_read_from_a_program_without_spans():
    """The parent program's window: kernels and host activity, no marker
    and no program range."""
    ctx = _ctx([_kernel(0, 1), _kernel(2, 1)],
               [("cudaGraphLaunch", 0, MS)])
    for metric in SPAN_METRICS:
        assert _read(metric, ctx) is None


TRAIN = ["sqdet.train.b20k8"]
SCORE = ["sqdet.score.b128", "sqdetplus.score.b128"]
TRAIN_PHASES = ["ingest", "matcher", "forward", "backward", "optimizer"]
# name: (reader, unit, moves, cells)
EXPECTED = {
    **{"span_ms.train." + p: ("span_ms", "ms", "train_img_s", TRAIN)
       for p in TRAIN_PHASES},
    **{"span_ms.score." + p: ("span_ms", "ms", "score_img_s", SCORE)
       for p in ["ingest", "backbone", "interpret", "postprocess"]},
    **{"span_kernels.train." + p: ("span_kernels", "kernels", "train_img_s",
                                   TRAIN) for p in TRAIN_PHASES},
    **{"host_ms.train." + p: ("host_ms", "ms", "train_img_s", TRAIN)
       for p in ["stage", "replay"]},
    "span_idle.train.replay": ("span_idle", "%", "train_img_s", TRAIN),
}
SPAN_METRICS = sorted(EXPECTED)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_entries_resolve_to_their_readers(metric):
    bench = run.load_json("BENCHMARK.json")
    entry = {m["name"]: m for m in bench["per_layer"]}[metric]
    stem, unit, moves, cells = EXPECTED[metric]
    assert run.reader(metric).__file__.endswith(
        "/metrics/{}.py".format(stem))
    assert (entry["unit"], entry["moves"], entry["workloads"]) == \
        (unit, moves, cells)
    assert entry["source"] == "device_trace" and entry["better"] == "lower"
    for cell in cells:
        assert metric in {m["name"] for m in
                          run.cell_spec(bench, cell)["per_layer"]}


def test_the_benchmark_has_the_17_span_entries_last():
    names = [m["name"] for m in run.load_json("BENCHMARK.json")["per_layer"]]
    assert len(SPAN_METRICS) == 17
    assert sorted(names[-17:]) == SPAN_METRICS
