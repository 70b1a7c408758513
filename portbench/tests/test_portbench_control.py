"""The control comes out not correct on the card: the reference in
float8, the step below the configuration's bfloat16, put in the
program's place, judged as the program is, at the cells' widths and
image sizes with fewer images, on three seeds.  Run on a card with
``python3 -m pytest portbench/tests -m cuda``."""

import importlib

import pytest
import torch

from portbench import run
from portbench.reference.precision import fp8

SMALL = {"sqdet.score.b128": dict(batch=32, pool=1),
         "sqdetplus.score.b128": dict(batch=16, pool=1),
         "sqdet.train.b20k8": dict(dataset_images=64, feed_dispatches=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102, 103])
@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_and_program_passes(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = run.cell_spec(run.load_json("BENCHMARK.json"), cell)
    mix = dict(spec["mix"], **SMALL[cell])
    runner = importlib.import_module(
        "portbench.runners." + mix["runner"]).Runner(
            spec["cfg"], mix, seed, "cuda")
    runner.setup()
    runner.window(1.0)
    runner.release()
    assert run.judge(runner.check(), spec["limits"])[1]
    assert not run.judge(runner.check(quant=fp8), spec["limits"])[1]
