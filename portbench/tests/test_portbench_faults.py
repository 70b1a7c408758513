"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip skipped, each cell at a tiny size on the CPU
with a fault planted in the program, once for each fault the cell can
have.  The same runs unbroken come out correct."""

import pytest
import torch

from portbench import run
from portbench.tests import tiny

MIXES = {"sqdet.score.b128": tiny.SCORE, "sqdetplus.score.b128": tiny.SCORE,
         "sqdet.train.b20k8": tiny.TRAIN}


def _run(cell, seed=21):
    spec = tiny.cell(cell, **MIXES[cell])
    if spec["mix"]["runner"] == "train":
        # at 2 x 128 x 64 bfloat16's first gradients part from float32's
        # by more than at the cell's size: the program trains in float32
        spec["cfg"]["compute_dtype"] = "float32"
    return run.run_cell(spec, seed, 0.3, 0, device="cpu")


def _fails_a_limit(result):
    return result["correct"] is False and any(
        c["limit"] is not None and c["value"] > c["limit"]
        for c in result["checks"].values())


def half_batch_scored(monkeypatch):
    """The first half of each batch scored, its answers sent for both
    halves."""
    from squeezedet_torch.models import Detector
    orig = Detector.predict_raw_postprocessed

    def half(self, images_u8, spatial=None):
        h = images_u8.shape[0] // 2
        out = orig(self, images_u8[:h], spatial)
        return tuple(torch.cat([o, o]) for o in out)
    monkeypatch.setattr(Detector, "predict_raw_postprocessed", half)


def answer_altered(monkeypatch):
    """Each detection's class moved on by one where the filter makes it."""
    from squeezedet_torch.models import Detector
    orig = Detector.postprocess_device

    def altered(self, interp):
        boxes, probs, classes, keep = orig(self, interp)
        return boxes, probs, (classes + 1) % self.cfg.classes, keep
    monkeypatch.setattr(Detector, "postprocess_device", altered)


def state_unchanged(monkeypatch):
    """The optimizer counts its step and changes nothing."""
    from squeezedet_torch.optim import Momentum

    def update(self, neg_lr=None):
        self.step += 1
    monkeypatch.setattr(Momentum, "update", update)


def half_batch_trained(monkeypatch):
    """The loss and its gradient taken over the first half of the batch,
    the mean over those rows."""
    from squeezedet_torch import trainer
    from squeezedet_torch.models.skeleton import Targets
    orig = trainer._rank_loss

    def half(det, images, targets, generator, dp=None, spatial=None):
        h = images.shape[0] // 2
        return orig(det, images[:h], Targets(*(t[:h] for t in targets)),
                    generator, dp, spatial)
    monkeypatch.setattr(trainer, "_rank_loss", half)


FAULTS = {
    "sqdet.score.b128": [half_batch_scored, answer_altered],
    "sqdetplus.score.b128": [half_batch_scored, answer_altered],
    "sqdet.train.b20k8": [state_unchanged, half_batch_trained],
}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, fs in FAULTS.items() for f in fs],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    assert _fails_a_limit(_run(cell))


@pytest.mark.parametrize("cell", list(FAULTS))
def test_unbroken_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]


class _Dropped:
    """A captured dispatch's input buffer whose copy is dropped: the
    graph replays with the inputs that the buffer held before."""

    def __init__(self, buf):
        self.buf = buf

    def copy_(self, src, non_blocking=False):
        return self.buf


@pytest.mark.cuda
def test_replay_inputs_dropped_is_not_correct():
    """On the card only, where the window replays a captured graph: each
    window dispatch's inputs left out of the graph's buffers (every
    replay after the set-up one trains on the set-up one's rows) come
    out not correct, by the window's numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import importlib
    spec = run.cell_spec(run.load_json("BENCHMARK.json"),
                         "sqdet.train.b20k8")
    mix = dict(spec["mix"], dataset_images=64)
    runner = importlib.import_module("portbench.runners.train").Runner(
        spec["cfg"], mix, 104, "cuda")
    runner.setup()
    runner.scan.inputs = [_Dropped(b) for b in runner.scan.inputs]
    runner.window(1.0)
    runner.release()
    assert runner.last["feed"] != 1
    checks, correct = run.judge(runner.check(), spec["limits"])
    assert not correct
    assert any(checks[n]["value"] > checks[n]["limit"]
               for n in ("window_loss_gap", "window_step_gap"))
