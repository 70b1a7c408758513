#!/usr/bin/env python3
"""The two bf16 kernels of K2 against each other on 1x1 calls around the
fixed rule ``squeezedet_torch.ops.filter_grad.uses_mma`` picks by: the
mma.sync kernel and the TMA + wgmma kernel, each with its own plan, at
the O, C and position counts where the rule turns.  Needs a CUDA card.

    python3 scripts/k2_rule.py [--out k2_rule.json]

Each shape is timed in 3 rounds of (mma.sync, wgmma, wgmma, mma.sync) by
``chip_smoke.graph_ms`` (10 launches captured in a CUDA graph, replayed
3 times: the device's time alone); every reading is printed, sorted,
with the kernel the rule picks.  ``chip_smoke.py`` times both kernels at
the 1x1 shapes the models run; this covers the shapes between them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (its timer)

# (B, C, O, H, W) of 1x1 calls: O from 128 to 288 at C = 128; C = 256 at
# O = 64-256 from 37,440 to 239,616 positions; C = 384
SHAPES = ([(20, 128, o, h, w) for o in (128, 160, 192, 208, 224, 256, 288)
           for h, w in ((24, 78), (45, 153))]
          + [(b, 128, o, 24, 78) for b in (128,) for o in (160, 192, 256)]
          + [(b, 256, o, 24, 78) for o in (64, 96, 128, 192, 256)
             for b in (20, 28, 36, 48, 64, 128)]
          + [(b, 384, 96, 24, 78) for b in (20, 36)]
          + [(20, 384, o, 22, 76) for o in (128, 256)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    from squeezedet_torch.ops import filter_grad as fg
    if not torch.cuda.is_available():
        raise SystemExit("k2_rule: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for b, c, o, h, w in SHAPES:
        x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
        dy = torch.randn(b, h, w, o, device="cuda", generator=gen).bfloat16()
        plans = {"mma.sync": fg.mma_plan(b, h, w, c, o, 1, 1),
                 "wgmma": fg.wgmma_plan(b, h, w, c, o, 1, 1)}
        ms = {k: [] for k in plans}
        for _ in range(3):
            for k in ("mma.sync", "wgmma", "wgmma", "mma.sync"):
                ms[k].append(cs.graph_ms(
                    lambda: fg.launch(x, dy, 1, 1, plans[k])))
        rule = "mma.sync" if fg.uses_mma(b, h, w, c, o, 1, 1) else "wgmma"
        rows.append({"B": b, "C": c, "O": o, "H": h, "W": w, "rule": rule,
                     **{k: sorted(v) for k, v in ms.items()}})
        print("B={} C={} O={} {}x{} ({} positions), rule {}: mma.sync {} / "
              "wgmma {} ms".format(
                  b, c, o, h, w, b * h * w, rule,
                  " ".join("{:.4f}".format(v) for v in sorted(ms["mma.sync"])),
                  " ".join("{:.4f}".format(v) for v in sorted(ms["wgmma"]))),
              flush=True)
        del x, dy
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
