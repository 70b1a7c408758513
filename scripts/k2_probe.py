"""K2 alone on the card: builds both kernels, then runs ``chip_smoke.py``'s
phase 4 (K2 against its plain version at the train and odd shapes, on
one-signed operands against cuDNN's f32 weight gradient, and timed at
the train shapes) and its backbone-shape checks and timings; prints the
log and, last, one JSON line of phase 4's summary and the per-shape rows.

Run from the root of a checkout, on a machine with a CUDA card:

    python scripts/k2_probe.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import chip_smoke as cs  # noqa: E402


def main():
    t0 = time.perf_counter()
    card = cs.phase_device()
    cs.phase_build()
    k2, rows = cs.phase_k2(card)
    _, backbone_rows = cs.phase_k2_backbones(card)
    cs.log("k2_probe took {:.1f} s".format(time.perf_counter() - t0))
    print(json.dumps({"k2": k2, "rows": rows,
                      "backbone_rows": backbone_rows}))


if __name__ == "__main__":
    main()
