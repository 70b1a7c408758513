"""The readings that the limits in ``portbench/limits/`` are set from:
for each seed, the program's numbers after a short window at the cell's
own size, and the control's (the reference in float8 in the program's
place) and the planted faults' on the same inputs, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 \\
        [--control] [--faults] [--seconds 2]

One JSON line a seed and kind on standard output."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

from portbench import run


def faults(runner):
    """{fault: (numbers, detail)} of the faults a cell of this kind can
    have, planted in the reference put in the program's place, or by
    measure."""
    if runner.mix["runner"] != "train":
        return {}
    out = {}

    def read(name, run):
        out[name] = (runner.check(run=run), dict(runner.detail))
    read("half_batch", runner.reference_run(
        rows=slice(0, runner.mix["batch"] // 2)))
    mine = runner.program_run()
    start = runner.last["start"]
    params, momentum, _ = runner.end
    read("unchanged", dict(
        mine, setup=(mine["setup"][0],
                     {n: runner.weights[n] for n in params},
                     {n: 0 * t for n, t in momentum.items()}),
        window=(mine["window"][0], start[0], start[1])))
    # the window's last dispatch run on the inputs of the one before it
    # (a dispatch's inputs dropped), the rest the program's own
    stale = (runner.last["feed"] - 1) % len(runner.feed)
    read("stale_inputs", dict(
        mine, window=runner.reference_run(window_feed=stale)["window"]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    for var, sub in run.CACHES.items():
        os.environ[var] = os.path.join(run.ROOT, ".portbench_cache", sub)
    cell = run.cell_spec(run.load_json("BENCHMARK.json"), args.workload)
    run.require_device(cell["chips"])
    from portbench.reference.precision import fp8
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        runner = importlib.import_module(
            "portbench.runners." + cell["mix"]["runner"]).Runner(
                cell["cfg"], cell["mix"], seed, "cuda")
        t = time.perf_counter()
        runner.setup()
        win = runner.window(args.seconds)
        runner.release()
        rows = [("program", runner.check(),
                 dict(getattr(runner, "detail", {})))]
        if args.control:
            rows.append(("control", runner.check(quant=fp8),
                         dict(getattr(runner, "detail", {}))))
        if args.faults:
            rows += [(k, v, d) for k, (v, d) in faults(runner).items()]
        for kind, numbers, detail in rows:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "kind": kind, "numbers": numbers,
                               "window": {k: win[k] for k in
                                          ("seconds", "attempted")},
                               "elapsed_s": time.perf_counter() - t,
                               "detail": detail})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del runner
    return 0


if __name__ == "__main__":
    sys.exit(main())
