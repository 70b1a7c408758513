"""Deterministic training in the port (``trainer.deterministic``): the
train loop runs under it and gives the caller's settings back, also when
it fails; the data-parallel dry run's step runs under it; an op with no
deterministic implementation raises inside it; ``train.main`` sets
cuBLAS' workspace before anything touches CUDA; and a resumed train CLI
run still equals a straight one bit for bit on the CPU, at one step per
dispatch and at two, in f32 and in bf16 with ``--pallas_grads``."""

import os

import numpy as np
import pytest
import torch

from squeezedet_torch import train as port_cli
from squeezedet_torch import trainer
from squeezedet_torch.checkpoint.manager import CheckpointManager, latest_step
from squeezedet_torch.parallel import dryrun
from synth_kitti import make_synth_kitti
from torch_threads import one_thread  # noqa: F401  (autouse)

cudnn = torch.backends.cudnn


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_det"))
    make_synth_kitti(root, num_images=6, width=96, height=96)
    return root


def _settings():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark)


@pytest.fixture
def lax_settings():
    """The caller's settings: nondeterministic, cuDNN autotuning on."""
    before = _settings()
    torch.use_deterministic_algorithms(False)
    cudnn.deterministic, cudnn.benchmark = False, True
    yield (False, False, False, True)
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    cudnn.deterministic, cudnn.benchmark = before[2:]


def _argv(root, train_dir, steps, *extra):
    return ["--device", "cpu", "--data_path", root, "--train_dir", train_dir,
            "--image_width", "96", "--image_height", "96", "--batch_size",
            "2", "--max_steps", str(steps), "--checkpoint_step", "2",
            "--summary_step", "0", "--device_assign", "--uint8_ingest",
            "--device_augment", *extra]


def test_train_runs_deterministic_and_restores(kitti_root, tmp_path,
                                               lax_settings, monkeypatch):
    seen = []
    real = trainer.make_train_step_device

    def spy(*args, **kw):
        step = real(*args, **kw)

        def recorded(*a, **k):
            seen.append(_settings())
            return step(*a, **k)
        return recorded
    monkeypatch.setattr(trainer, "make_train_step_device", spy)
    port_cli.main(_argv(kitti_root, str(tmp_path / "a"), 2))
    assert seen == [(True, False, True, False)] * 2
    assert _settings() == lax_settings

    def fail(*a, **k):
        raise RuntimeError("step failed")
    monkeypatch.setattr(trainer, "make_train_step_device",
                        lambda *a, **k: fail)
    with pytest.raises(RuntimeError, match="step failed"):
        port_cli.main(_argv(kitti_root, str(tmp_path / "b"), 2))
    assert _settings() == lax_settings


def test_mode_raises_on_a_nondeterministic_op(lax_settings):
    with trainer.deterministic():
        with pytest.raises(RuntimeError, match="deterministic"):
            torch.zeros(4).put_(torch.tensor([1, 1]), torch.ones(2))
    assert _settings() == lax_settings


def test_dryrun_step_runs_deterministic(tmp_path, lax_settings,
                                        monkeypatch):
    import squeezedet_torch as st
    det = st.get_model("squeezeDet", st.tiny_test_config(batch_size=2),
                       device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    batch = [rs.randint(0, 256, (2, 96, 96, 3), dtype=np.uint8),
             np.tile(np.float32([[[40, 40, 20, 30]]]), (2, 1, 1)),
             np.zeros((2, 1), np.int64), np.ones(2, np.int64)]
    path = str(tmp_path / "case.pt")
    dryrun.write_case(path, det, batch)
    seen = []
    real = trainer.make_train_step_device

    def spy(*args, **kw):
        step = real(*args, **kw)
        return lambda *a, **k: (seen.append(_settings()), step(*a, **k))[1]
    monkeypatch.setattr(trainer, "make_train_step_device", spy)
    out = dryrun.one_step(dryrun.load_case(path))
    assert out["step"] == 1 and seen == [(True, False, True, False)]
    assert _settings() == lax_settings


def test_main_sets_the_cublas_workspace(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(SystemExit, match="ROADMAP"):
        port_cli.main(["--device", "cpu", "--compilation_cache", "x"])
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with pytest.raises(SystemExit):
        port_cli.main(["--device", "cpu", "--compilation_cache", "x"])
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


def _final_state(train_dir):
    """The params and momentum of the run's last checkpoint (step index
    3, written after the fourth step)."""
    tree = CheckpointManager(train_dir)._load(latest_step(train_dir))
    return tree["params"], tree["opt_state"]["momentum"]


@pytest.mark.parametrize("k,dtype", [(1, "float32"), (2, "bfloat16")])
def test_resume_is_bit_exact_under_the_mode(kitti_root, tmp_path, k, dtype):
    """4 steps straight equal 2 steps plus a 2-step resume, params and
    momentum bit for bit."""
    extra = ["--steps_per_dispatch", str(k), "--compute_dtype", dtype,
             "--pallas_grads"]
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    port_cli.main(_argv(kitti_root, straight, 4, *extra))
    port_cli.main(_argv(kitti_root, resumed, 2, *extra))
    assert port_cli.main(_argv(kitti_root, resumed, 4, *extra)).step == 4
    assert latest_step(straight) == latest_step(resumed) == 3
    for want, got in zip(_final_state(straight), _final_state(resumed)):
        assert want.keys() == got.keys()
        for name in want:
            assert torch.equal(want[name], got[name]), name
