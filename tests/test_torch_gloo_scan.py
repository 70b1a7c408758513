"""K train steps per dispatch over gloo ranks (``--steps_per_dispatch``
with a gloo ``DataParallel``: ``trainer.make_train_step_device_scan``
and ``trainer.train``), on spawned gloo ranks at the tiny config with
dropout on (``parallel/dryrun.py``):

* two ranks at K=2 equal two K=1 steps over the same ranks, bit for bit;
* two ranks at K=2 match the one-process K=2 scan within the dry run's
  tolerances (that scan is held to the JAX package's ``lax.scan`` by
  ``test_torch_dispatch.py::test_scanned_steps_match_jax_scan``);
* 2 ranks x 2 height tiles at K=2 match the unsharded one-process scan
  within the tolerances of the JAX package's
  ``tests/test_spatial.py::test_scan_dispatch_on_2d_mesh`` (its (2, 2)
  mesh: loss rtol 1e-5, parameters rtol 1e-4 and atol 1e-6);
* the train CLI over two ranks at ``--steps_per_dispatch 2`` writes the
  checkpoint of its K=1 run, bit for bit (marked slow);

and on the card (``cuda``-marked), where a gloo rank's K steps are
captured as a chain of CUDA graphs split at its all-reduces
(``trainer._GraphChain``), the replayed dispatches equal the same steps
run eagerly, bit for bit.  The file imports no JAX, so the card's case
runs where JAX is not installed (``--noconftest``).
"""

import os

import numpy as np
import pytest
import torch

from squeezedet_torch import train as port_cli
from squeezedet_torch.checkpoint.manager import STATE_FILE
from squeezedet_torch.parallel import dryrun
from torch_threads import one_torch_thread

K = 2
RANKS = 2


def _assert_equal_runs(got, want, what):
    assert got["step"] == want["step"], what
    assert torch.equal(got["loss"], want["loss"]), what
    assert torch.equal(got["generator"], want["generator"]), what
    for key in ("params", "momentum"):
        for name, t in want[key].items():
            assert torch.equal(got[key][name], t), (what, key, name)


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread here and in the ranks spawned meanwhile (they
    read ``OMP_NUM_THREADS`` when torch starts): the tensors are tiny,
    and in a run of several test processes on the same cores more
    threads only contend."""
    with one_torch_thread(spawned=True):
        yield


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, one_thread):
    """Two gloo ranks, each running the case's 2 stacked steps at K=1 and
    at K=2 from the same start, and the one-process K=2 scan."""
    tmp = tmp_path_factory.mktemp("gloo_scan")
    path = str(tmp / "case.pt")
    case = dryrun.tiny_case(path, RANKS, ks=(1, K), steps=K)
    results = dryrun.step_on_ranks(path, str(tmp / "out"), RANKS)
    return case, results, dryrun.scan_steps(case, K)


def test_two_ranks_scan_equals_single_steps(two_ranks):
    """On each rank the K=2 dispatch is the two K=1 steps: the same loss
    terms, parameters, momentum, optimizer step and dropout generator."""
    _, results, _ = two_ranks
    for rank, by_k in enumerate(results):
        assert by_k[K]["loss"].shape == (K, 5)
        assert by_k[K]["step"] == 5 + K
        assert by_k[K]["backend"] == "gloo"
        _assert_equal_runs(by_k[K], by_k[1], "rank {}".format(rank))


def test_two_ranks_scan_matches_one_process_scan(two_ranks):
    """Each rank's K=2 dispatch over its half of the global batch against
    one process's K=2 scan of the whole batch (``dryrun.agrees``)."""
    case, results, want = two_ranks
    assert want["loss"].shape == (K, 5) and torch.isfinite(
        want["loss"]).all()
    for rank, by_k in enumerate(results):
        m = dryrun.worst_mismatch(by_k[K], want, case["weights"])
        assert dryrun.agrees(m), (rank, m)


def test_data_x_spatial_scan_matches_unsharded_scan(tmp_path, one_thread):
    """The JAX package's (2, 2) mesh scan: two gloo ranks, each over 2
    height tiles of its rows, K=2 scanned steps with dropout on, against
    the unsharded one-process scan."""
    path = str(tmp_path / "case.pt")
    case = dryrun.tiny_case(path, RANKS, spatial=2, ks=(K,), steps=K)
    want = dryrun.scan_steps(dict(case, spatial=1), K)
    results = dryrun.step_on_ranks(path, str(tmp_path / "out"), RANKS)
    for rank, by_k in enumerate(results):
        got = by_k[K]
        assert got["step"] == want["step"] == 5 + K
        torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-5,
                                   atol=0)
        for name, w in want["params"].items():
            np.testing.assert_allclose(
                got["params"][name].numpy(), w.numpy(), rtol=1e-4,
                atol=1e-6, err_msg="rank {} {}".format(rank, name))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    from synth_kitti import make_synth_kitti
    root = str(tmp_path_factory.mktemp("kitti_gloo_scan"))
    make_synth_kitti(root, num_images=8, width=96, height=96)
    return root


def _state(train_dir, step):
    return torch.load(os.path.join(str(train_dir), "model.ckpt-{}".format(
        step), STATE_FILE), map_location="cpu", weights_only=True)


@pytest.mark.slow
def test_two_rank_cli_scan_writes_its_single_step_checkpoint(
        kitti_root, tmp_path, capfd, one_thread):
    """``--num_devices 2 --steps_per_dispatch 2`` to step 4: two
    dispatches, a checkpoint after each, every rank's sampler snapshot,
    and the last checkpoint equal to the K=1 run's, bit for bit.  Slow
    (≈ 35 s alone, ≈ 115 s among six test processes, most of it the
    summary writer's tensorboard import in each run's rank 0), as the
    JAX package's ``test_two_process_scanned_dispatch_matches_single``."""
    def run(train_dir, *extra):
        port_cli.main([
            "--device", "cpu", "--data_path", kitti_root, "--train_dir",
            str(train_dir), "--image_width", "96", "--image_height", "96",
            "--batch_size", "4", "--max_steps", "4", "--checkpoint_step",
            "2", "--summary_step", "1000", "--device_assign",
            "--uint8_ingest", "--num_devices", str(RANKS), *extra])
    run(tmp_path / "k1")
    run(tmp_path / "k2", "--steps_per_dispatch", str(K))
    out = capfd.readouterr().out
    assert "sec/2-step dispatch" in out
    names = sorted(os.listdir(tmp_path / "k2"))
    assert [n for n in names if n.startswith("model.ckpt")] == [
        "model.ckpt-1", "model.ckpt-3"]
    for step in (1, 3):
        assert ["sampler.ckpt-{}.p{}.npz".format(step, r)
                for r in range(RANKS)] == [
            n for n in names if n.startswith("sampler.ckpt-{}.".format(
                step))]
    a, b = _state(tmp_path / "k1", 3), _state(tmp_path / "k2", 3)
    assert a["step"] == b["step"] == 4
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
    for name, t in a["opt_state"]["momentum"].items():
        assert torch.equal(t, b["opt_state"]["momentum"][name]), name


@pytest.mark.cuda
def test_segmented_replay_equals_eager_steps_on_the_card(tmp_path):
    """Two gloo ranks sharing the card, 6 f32 steps of the tiny config
    with dropout on: K=2 dispatches (eager, then captured as a chain of
    graphs split at the all-reduces and replayed, then replayed) against
    the same steps run one at a time, bit for bit, with K1 launched once
    per step's forward in both, replays counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    path = str(tmp_path / "case.pt")
    case = dryrun.tiny_case(path, RANKS, ks=(1, K), steps=3 * K)
    case["device"] = "cuda"
    torch.save(case, path)
    results = dryrun.step_on_ranks(path, str(tmp_path / "out"), RANKS)
    for rank, by_k in enumerate(results):
        assert by_k[K]["backend"] == "gloo"
        assert by_k[1]["k1"] == by_k[K]["k1"] == 3 * K
        _assert_equal_runs(by_k[K], by_k[1], "rank {}".format(rank))
