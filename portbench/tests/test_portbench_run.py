"""The command's arguments, its last line, and its refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests import tiny

ROOT = run.ROOT


def _main(capsys, argv, **kw):
    rc = run.main(argv, **kw)
    out, err = capsys.readouterr()
    return rc, out, err


def test_last_line_on_success(capsys):
    cell = tiny.cell("sqdet.score.b128", **tiny.SCORE)
    rc, out, err = _main(capsys, ["--workload", "sqdet.score.b128",
                                  "--seed", str(2 ** 31 + 11),
                                  "--seconds", "0.2", "--trace", "0"],
                         cell=cell, device="cpu")
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert set(result["metrics"]) == {"score_img_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] >= 1 and result["failed"] == 0
    # each number compared, beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in tail] == list(result["checks"])


def test_traced_line_has_breakdown(capsys):
    cell = tiny.cell("sqdet.train.b20k8", **tiny.TRAIN)
    rc, out, _ = _main(capsys, ["--workload", "sqdet.train.b20k8",
                                "--seed", "5", "--seconds", "0.2",
                                "--trace", "1"], cell=cell, device="cpu")
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    # no device ran in a CPU run: no per-layer number is read from it
    assert result["metrics"] == {}


def test_error_prints_no_result(capsys, monkeypatch):
    cell = tiny.cell("sqdet.score.b128", **tiny.SCORE)
    from portbench.runners import score

    def broken(self):
        raise RuntimeError("injected")
    monkeypatch.setattr(score.Runner, "setup", broken)
    rc, out, err = _main(capsys, ["--workload", "x", "--seed", "1",
                                  "--seconds", "1", "--trace", "0"],
                         cell=cell, device="cpu")
    assert rc == 1 and out == ""
    assert json.loads(err.strip().splitlines()[-1]) == {
        "error": "RuntimeError: injected"}


@pytest.mark.parametrize("argv", [
    [],
    ["--workload", "sqdet.score.b128", "--seed", "1", "--seconds", "10"],
    ["--workload", "sqdet.score.b128", "--seed", "x", "--seconds", "10",
     "--trace", "0"],
    ["--workload", "sqdet.score.b128", "--seed", "1", "--seconds", "0",
     "--trace", "0"],
    ["--workload", "sqdet.score.b128", "--seed", "1", "--seconds", "10",
     "--trace", "2"],
])
def test_bad_arguments_exit(argv):
    with pytest.raises(SystemExit) as e:
        run.parse_args(argv)
    assert e.value.code != 0


def test_arguments_parse():
    a = run.parse_args(["--workload", "sqdet.train.b20k8", "--seed",
                        str(2 ** 31 + 7), "--seconds", "20", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "sqdet.train.b20k8", 2 ** 31 + 7, 20.0, 1)


def test_unknown_workload(capsys):
    rc, out, err = _main(capsys, ["--workload", "no.such.cell", "--seed",
                                  "1", "--seconds", "1", "--trace", "0"],
                         device="cpu")
    assert rc == 1 and out == "" and "no.such.cell" in err


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sqdet.score.b128", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _command(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "cuda" in proc.stderr.lower()


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = _command(tmp_path, env)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("name,found", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("squeezedet_tpu", True),
    ("squeezedet_tpu.models", True), ("bench", True),
    ("jaxtyping", False), ("squeezedet_torch.models", False),
    ("benchmarks", False)])
def test_forbidden_by_top_level_name(monkeypatch, name, found):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in run.forbidden_loaded()) is found


def test_jax_loaded_refuses_result(capsys, monkeypatch):
    cell = tiny.cell("sqdet.score.b128", **tiny.SCORE)
    monkeypatch.setitem(sys.modules, "jax", object())
    rc, out, err = _main(capsys, ["--workload", "sqdet.score.b128",
                                  "--seed", "3", "--seconds", "0.1",
                                  "--trace", "0"], cell=cell, device="cpu")
    assert rc == 4 and out == "" and "jax" in err


@pytest.mark.cuda
def test_markers_load_in_set_up_never_in_the_traced_window(capsys,
                                                           monkeypatch):
    """squeezeDet+ never launches K1, whose library holds the span
    markers: a traced run loads them after set-up, before the window
    opens, and the window's first span finds them loaded."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from squeezedet_torch.utils import profiling
    from portbench import trace as tracing
    events = []
    load, enter, leave = (profiling.load_markers, tracing.Window.__enter__,
                          tracing.Window.__exit__)

    def spy_load(device):
        events.append("load")
        return load(device)

    def spy_enter(self):
        events.append("open")
        return enter(self)

    def spy_exit(self, *exc):
        events.append("close")
        return leave(self, *exc)
    # as in a process that has loaded none
    monkeypatch.setattr(profiling, "_MARKERS_LOADED", set())
    monkeypatch.setattr(profiling, "load_markers", spy_load)
    monkeypatch.setattr(tracing.Window, "__enter__", spy_enter)
    monkeypatch.setattr(tracing.Window, "__exit__", spy_exit)
    cell = tiny.cell("sqdetplus.score.b128", **tiny.SCORE)
    rc, out, _ = _main(capsys, ["--workload", "sqdetplus.score.b128",
                                "--seed", "17", "--seconds", "0.2",
                                "--trace", "1"], cell=cell, device="cuda")
    assert rc == 0
    assert events.count("open") == events.count("close") == 1
    opened, closed = events.index("open"), events.index("close")
    assert "load" in events[:opened]
    assert "load" not in events[opened:closed]
    result = json.loads(out.strip().splitlines()[-1])
    assert "span_ms.score.backbone" in result["metrics"]
