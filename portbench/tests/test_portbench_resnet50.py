"""ResNet50-ConvDet (``resnet50_kitti``, its reference
``portbench/reference/resnet50.py``): its counts at the published size
against the configuration file and the program's tracer; its published
widths through the program at a tiny image size; and, with every stage
present at narrow widths, the program (in float32) through both runners
against the reference with statistics that are not the identity, and
the planted faults coming out not correct."""

import numpy as np
import pytest
import torch

from portbench import faults, frozen, program, run, traffic
from portbench.reference import network
from portbench.tests import tiny
from portbench.tests.test_portbench_faults import (half_batch_trained,
                                                   state_unchanged)
from portbench.tests.test_portbench_reference import (
    TRAIN_1, _runner, scores_as_the_reference, trains_as_the_reference)

SCORE, TRAIN = "res50.score.b128", "res50.train.b20k8"
BIG = 2 ** 31 + 4321


def _cfg():
    return run.load_json("portbench", "configs", "resnet50_kitti.json")


def program_stages(cfg):
    """The configuration's stages as the program's ``resnet50._STAGES``
    writes them."""
    return [(s["stage"][len("res"):],
             [chr(ord("a") + i) for i in range(s["blocks"])], s["mid"],
             s["out"], s["frozen"]) for s in cfg["stages"]]


def test_counts_at_the_published_size():
    """FLOP, parameters, grid, layers and the trained leaves of the
    reference equal the file's and the program's (built on the meta
    device: shapes only)."""
    from squeezedet_torch.models import get_model, resnet50
    cfg = _cfg()
    net = network(cfg)
    assert net.__name__ == "portbench.reference.resnet50"
    assert program_stages(cfg) == resnet50._STAGES
    pcfg = program.program_config(cfg, 128)
    assert pcfg.batch_norm_epsilon == cfg["batch_norm_epsilon"]
    det = get_model(cfg["net"], pcfg, device="meta")
    tracer = det.backbone.tracer
    flops = frozen.forward_flops(cfg)
    assert flops == cfg["forward_flops"] == sum(
        f for _, f in tracer.flop_counter) == 61_283_686_016
    shapes = net.param_shapes(cfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg["params"] \
        == sum(p.numel() for p in det.backbone.parameters()) == 9_206_984
    params = dict(det.backbone.named_parameters())
    assert {n: tuple(p.shape) for n, p in params.items()} == shapes
    assert {n: tuple(b.shape) for n, b in det.backbone.named_buffers()} \
        == net.buffer_shapes(cfg)
    assert net.frozen_params(cfg) == {n for n, p in params.items()
                                      if not p.requires_grad}
    assert len(shapes) - len(net.frozen_params(cfg)) == 19 * 3 + 2
    assert net.grid(cfg) == (24, 78) == (tracer.height, tracer.width)
    assert len(net.buffer_shapes(cfg)) == 2 * 43
    assert net.dropout_parts(cfg) == [(24, 78, (1024,))]
    assert net.k2_routed(cfg) == []


def test_published_widths_through_the_program():
    """The file's own stages, at the tiny image size: the program's
    forward in float32 is the reference's."""
    cfg = tiny.tiny_config(_cfg())
    cfg["compute_dtype"] = "float32"
    weights = traffic.model_weights(BIG, cfg, "cpu")
    det = program.detector(cfg, 2, weights, "cpu")
    images = traffic.uint8_images(BIG, "x", (2, 64, 128, 3), "cpu").float() \
        - torch.tensor(cfg["bgr_means"])
    with torch.no_grad():
        got = det.backbone(images)
    want = network(cfg).forward(cfg, weights, images)
    assert got.shape == (2, 4, 8, 72)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_seeded_statistics_are_not_the_identity():
    cfg = tiny.tiny_config(_cfg())
    net = network(cfg)
    a = net.draw(BIG, cfg, "cpu")
    assert set(a) == set(net.param_shapes(cfg)) | set(net.buffer_shapes(cfg))

    def cat(kind, part=""):
        return torch.cat([t for n, t in a.items()
                          if n.endswith(part + "." + kind)])
    assert cat("mean").abs().min() > 0 and cat("beta").abs().min() > 0
    assert cat("var").min() > 0 and cat("var").std() > 0.2
    assert (cat("gamma", "branch2c") / cfg["init"]["branch2c_gamma"]).mean() \
        == pytest.approx(1.0, abs=0.05)
    b = net.draw(BIG, cfg, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    # the statistics' own draw leaves the kernels' as he_weights gives it
    kernels = {n: s for n, s in net.param_shapes(cfg).items()
               if n.endswith((".weight", ".bias"))}
    he = traffic.he_weights(BIG, kernels, cfg["init"], "cpu")
    assert all(torch.equal(a[n], he[n]) for n in kernels)


# --- every stage, narrow widths ----------------------------------------------

NARROW = {"res2": (8, 32), "res3": (16, 64), "res4": (32, 128)}


@pytest.fixture
def narrow(monkeypatch):
    """The tiny configuration with each stage's widths cut (depths and
    strides as published), the program's ResNet50 built at them."""
    from squeezedet_torch.models import resnet50
    cfg = tiny.tiny_config(_cfg())
    for s in cfg["stages"]:
        s["mid"], s["out"] = NARROW[s["stage"]]
    monkeypatch.setattr(resnet50, "_STAGES", program_stages(cfg))
    return cfg


def test_narrow_scores_as_the_reference(narrow):
    scores_as_the_reference(_runner(SCORE, tiny.SCORE, 11, narrow))


@pytest.mark.parametrize("seed", [12, 13])
def test_narrow_trains_as_the_reference(narrow, seed):
    d = _runner(TRAIN, TRAIN_1, seed, narrow)
    trains_as_the_reference(d)
    # conv1, res2 and res3 stay out of the optimizer; no statistic is a leaf
    net = network(narrow)
    assert set(d.first_grads) == set(net.param_shapes(narrow)) - \
        net.frozen_params(narrow)


MIXES = {SCORE: tiny.SCORE, TRAIN: tiny.TRAIN}


def _run(cfg, cell, seed=21):
    spec = tiny.cell(cell, **MIXES[cell])
    spec["cfg"] = cfg
    if spec["mix"]["runner"] == "train":
        # as test_portbench_faults: at this size bfloat16's first
        # gradients part from float32's by more than at the cell's size
        cfg["compute_dtype"] = "float32"
    return run.run_cell(spec, seed, 0.3, 0, device="cpu")


PLANTED = {SCORE: ["bn_identity", "join_dropped"],
           TRAIN: ["bn_identity", "join_dropped", state_unchanged,
                   half_batch_trained]}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, fs in PLANTED.items() for f in fs],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(narrow, monkeypatch, cell, fault):
    if isinstance(fault, str):
        with faults.FAULTS[fault]():
            result = _run(narrow, cell)
    else:
        fault(monkeypatch)
        result = _run(narrow, cell)
    assert result["correct"] is False and any(
        c["limit"] is not None and c["value"] > c["limit"]
        for c in result["checks"].values()), result["checks"]


@pytest.mark.parametrize("cell", [SCORE, TRAIN])
def test_unbroken_is_correct(narrow, cell):
    result = _run(narrow, cell)
    assert result["correct"] is True, result["checks"]


def test_faults_main_runs_the_calibration_with_the_fault_planted(
        monkeypatch):
    seen = []

    def calibrate_main(argv):
        seen.append((argv, program.load is not load))
        return 0
    load = program.load
    monkeypatch.setattr(faults.calibrate, "main", calibrate_main)
    argv = ["--workload", TRAIN, "--seeds", "1", "2", "--seconds", "1"]
    assert faults.main(["--fault", "bn_identity"] + argv) == 0
    assert seen == [(argv, True)] and program.load is load


def test_faults_mend_the_program(narrow):
    from squeezedet_torch.models import layers, resnet50
    before = (program.load, resnet50.ResNet50._block, layers.pointwise)
    for fault in faults.FAULTS.values():
        with fault():
            pass
    assert (program.load, resnet50.ResNet50._block,
            layers.pointwise) == before



# the metrics whose cell lists the new cells were appended to
APPENDED = {
    SCORE: ["score_img_s", "mfu.score", "device_idle.score"]
    + ["span_ms.score." + p for p in ("ingest", "backbone", "interpret",
                                      "postprocess")],
    # not mfu.train: its reader counts three forwards an image, and this
    # net's frozen half (conv1 to res3) runs no backward
    TRAIN: ["train_img_s", "kernels_per_step.train", "device_idle.train",
            "host_ms.train.stage", "host_ms.train.replay",
            "span_idle.train.replay"]
    + [k + ".train." + p for k in ("span_ms", "span_kernels")
       for p in ("ingest", "matcher", "forward", "backward", "optimizer")],
}
# the metrics this configuration adds: (reader, unit, layer)
ADDED = {"span_ms.score.res2": ("span_ms", "ms", "backbone stage"),
         "span_ms.score.res3": ("span_ms", "ms", "backbone stage"),
         "span_ms.score.res4": ("span_ms", "ms", "backbone stage"),
         "span_kernels.score.backbone": ("span_kernels", "kernels",
                                         "backbone")}


@pytest.mark.parametrize("cell", [SCORE, TRAIN])
def test_benchmark_entries_of_the_new_cells(cell):
    """Each new cell in the lists it was added to, the four new metrics
    in ``per_layer`` and read by the existing readers, and the cell
    reporting them (wherever later entries put them)."""
    bench = run.load_json("BENCHMARK.json")
    by = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in APPENDED[cell]:
        assert cell in by[name]["workloads"], name
    for name, (stem, unit, layer) in ADDED.items():
        m = by[name]
        assert run.reader(m["name"]).__file__.endswith(
            "/metrics/{}.py".format(stem))
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == \
            (unit, layer, "score_img_s", "device_trace")
        assert SCORE in m["workloads"] and TRAIN not in m["workloads"]
    spec = run.cell_spec(bench, cell)
    reported = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    want = set(APPENDED[cell]) | {"setup_s"}
    if cell == SCORE:
        want |= set(ADDED)
    assert want <= reported
