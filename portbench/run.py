"""Run one cell of the port's benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``portbench/configs/<config>.json``)
and a traffic mix (``portbench/traffic/<traffic>.json``), whose
``runner`` (``portbench/runners/<runner>.py``) builds the program and
the inputs from the seed, warms every shape the cell uses, and drives
the measured window.  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` loads the program's span markers after the
runner's set-up, then profiles a window of the mix's ``trace_seconds``
and reports the per-layer metrics, each read by
``portbench/metrics/<metric>.py`` (or the reader named by the metric's
name before its first dot).  Then the window's outputs are judged
against the plain reference (``portbench/reference/``), each number
against its limit in ``portbench/limits/<cell>.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  Without a CUDA device, with fewer
than the cell's chips, when the program is missing, on any error, or
when the process has loaded the JAX package or JAX, the run prints its
reason on standard error, no result, and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names a run may not load: JAX, the JAX package, and
# the JAX package's root benchmark
FORBIDDEN = ("jax", "jaxlib", "flax", "squeezedet_tpu", "bench")
# every kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


class NoDevice(RuntimeError):
    """No CUDA device, or fewer than the cell asks for."""


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True,
                   help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True,
                   help="draws the weights, inputs and arrivals")
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), required=True,
                   help="1: profile the window, report per-layer metrics")
    args = p.parse_args(argv)
    if not args.seconds > 0:
        p.error("--seconds must be positive")
    return args


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell_spec(bench, name):
    """The cell's entry with its config, mix, limits and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError("no workload {!r} in BENCHMARK.json (have {})".format(
            name, ", ".join(sorted(cells))))
    cell = dict(cells[name])
    cell["cfg"] = load_json("portbench", "configs", cell["config"] + ".json")
    cell["mix"] = load_json("portbench", "traffic", cell["traffic"] + ".json")
    limits = os.path.join(ROOT, "portbench", "limits", name + ".json")
    cell["limits"] = load_json(limits) if os.path.exists(limits) else {}

    def reports(m):
        return name in m.get("workloads", [name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if reports(m)]
    moved = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if (reports(m) if "workloads" in m
                             else m["moves"] in moved)]
    return cell


def reader(metric):
    """The reader module of a per-layer metric."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError("no reader for metric " + metric)


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def require_device(chips):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice("the cell asks for {} CUDA devices, torch sees "
                       "{}".format(chips, torch.cuda.device_count()))


class Context:
    """What a per-layer reader reads: the cell's configuration and mix,
    the window's counts (``window``) and the trace's summary."""

    def __init__(self, cell, window, summary):
        self.cfg, self.mix = cell["cfg"], cell["mix"]
        self.window = window
        self.trace = summary


def judge(values, limits):
    """{name: {"value", "limit"}} and whether every number is within its
    limit; a number without a limit, or not finite, fails."""
    checks, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return checks, ok and bool(values)


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None):
    """One run of ``cell`` (:func:`cell_spec`); returns the result dict."""
    import torch
    from portbench import program, trace as tracing
    t_start = T_START if t_start is None else t_start
    mix = cell["mix"]
    runner = importlib.import_module("portbench.runners." + mix["runner"]) \
        .Runner(cell["cfg"], mix, seed, device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    print("set-up: process start to the runner {:.3f} s".format(
        time.perf_counter() - t_start), file=sys.stderr)
    runner.setup()
    setup_s = time.perf_counter() - t_start
    metrics, breakdown, dev = {}, None, {}
    if trace:
        if on_card:  # their first load (a build, in a fresh checkout)
            program.load_markers(device)
        with tracing.Window(cell["chips"], on_card) as tw:
            win = runner.window(mix["trace_seconds"])
        ctx = Context(cell, win, tw.summary)
        for m in cell["per_layer"]:
            value = reader(m["name"]).read(ctx, m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"busy_s": tw.summary.busy_s, "window_s": tw.summary.window_s}
        breakdown = {"device_ops": tw.summary.top_ops(),
                     "idle_gaps": tw.summary.idle_gaps()}
    else:
        win = runner.window(seconds)
        e2e = runner.end_to_end(win)
        e2e["setup_s"] = setup_s
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    runner.release()
    checks, correct = judge(runner.check(), cell["limits"])
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics,
              "device": device_info(device, cell["chips"], peak)}
    result["device"].update(dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def device_info(device, chips, peak):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def main(argv=None, cell=None, device="cuda"):
    """The command.  ``cell`` and ``device`` stand in for the named cell
    and the card in tests, which skip the look for a chip."""
    args = parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    try:
        if cell is None:
            cell = cell_spec(load_json("BENCHMARK.json"), args.workload)
        if device == "cuda":
            require_device(cell["chips"])
        result = run_cell(cell, args.seed, args.seconds, args.trace, device)
    except NoDevice as e:
        print("portbench: no result: {}".format(e), file=sys.stderr)
        return 3
    except Exception as e:  # the run failed: say why, print no result
        traceback.print_exc()
        print(json.dumps({"error": "{}: {}".format(type(e).__name__, e)}),
              file=sys.stderr)
        return 1
    loaded = forbidden_loaded()
    if loaded:
        print("portbench: no result: the process loaded {}".format(
            ", ".join(loaded)), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print("check {} = {!r} (limit {!r})".format(name, c["value"],
                                                    c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # the bytecode of every module the run imports, the installed torch's
    # too, written at a fixed path in the checkout only (where the
    # environment turns writing it off, for this process): later runs
    # there read it instead of compiling the sources again
    sys.pycache_prefix = os.path.join(ROOT, ".portbench_cache", "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
