"""Faults planted in the program underneath the harness, for the readings
that a cell's limits are set from and for the tests that see them come
out not correct: each a context manager that breaks the program on
entry and mends it on leaving.

    python3 -m portbench.faults --fault bn_identity \\
        --workload <cell> --seeds 1 2 3 [--seconds 1]

runs :mod:`portbench.calibrate` with the fault planted: its ``program``
lines are the broken program's readings.  The faults of the reference's
own making (half of the batch, an unchanged state) are
:mod:`portbench.calibrate`'s ``--faults``."""

from __future__ import annotations

import argparse
import contextlib
import sys
from unittest import mock

from portbench import calibrate, program

# the block whose join loses its shortcut: one of the trained stage's
# identity blocks, so that the forward and the gradients both change
JOIN_BLOCK = "res4c"


@contextlib.contextmanager
def bn_identity():
    """The program's batch-norm statistics left as the program makes them
    (mean 0, var 1): the harness's copy of the buffers skipped."""
    load = program.load

    def parameters_only(det, tensors, buffers=()):
        load(det, {n: t for n, t in tensors.items() if n not in buffers})
    with mock.patch.object(program, "load", parameters_only):
        yield


@contextlib.contextmanager
def join_dropped(block=JOIN_BLOCK):
    """ResNet50's block ``block`` joined without its shortcut:
    relu(branch2c)."""
    import torch
    from squeezedet_torch.models import layers, resnet50
    run_block, pointwise = resnet50.ResNet50._block, layers.pointwise

    def no_shortcut(fn, shortcut, y):
        return pointwise(fn, torch.zeros_like(shortcut), y)

    def broken(self, stage, name, x, tape):
        if "res" + stage + name != block:
            return run_block(self, stage, name, x, tape)
        with mock.patch.object(layers, "pointwise", no_shortcut):
            return run_block(self, stage, name, x, tape)
    with mock.patch.object(resnet50.ResNet50, "_block", broken):
        yield


FAULTS = {"bn_identity": bn_identity, "join_dropped": join_dropped}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    args, rest = p.parse_known_args(argv)
    with FAULTS[args.fault]():
        return calibrate.main(rest)


if __name__ == "__main__":
    sys.exit(main())
