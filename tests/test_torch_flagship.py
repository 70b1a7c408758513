"""The dry run at the flagship geometry (``parallel/dryrun.run_flagship``):
the full 1248x384 squeezeDet on gloo CPU ranks, one torch thread a
process."""

import numpy as np
import pytest
import torch

from squeezedet_torch.parallel import dryrun
from torch_threads import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process and the ranks it spawns on one torch thread each."""
    with one_torch_thread(spawned=True):
        yield


def test_flagship_case_is_the_published_geometry(tmp_path):
    """1248x384, 24 x 78 x 9 = 16,848 anchors, no pretrained weights, a
    fresh optimizer state and the JAX dry run's three boxes an image."""
    case = dryrun.flagship_case(str(tmp_path / "a.pt"), 2)
    cfg = case["cfg"]
    assert (cfg.image_width, cfg.image_height, cfg.batch_size) == \
        (1248, 384, 2)
    assert cfg.anchors == 16848 and not cfg.load_pretrained_model
    images, gt, labels, num_gt = case["batch"]
    assert images.shape == (2, 384, 1248, 3) and images.dtype == np.float32
    assert gt.shape == (2, dryrun.FLAGSHIP_GT, 4) and (num_gt == 3).all()
    assert (labels[:, 1] == 1).all() and not gt[:, 3:].any()
    assert case["opt_state"] is None and not case["uint8_ingest"]


def test_flagship_dataset_blocks_are_the_shards_rows(tmp_path):
    """The device-dataset case at 2 ranks: each rank's block is its own
    FLAGSHIP_ROWS rows of the shard-major stack a lone process holds,
    and the shard-local gather of a rank's plan rows reads what the
    lone process's index_select reads."""
    from squeezedet_torch.parallel.distributed import DataParallel
    from squeezedet_torch.parallel.mesh import local_shard_gather
    case = dryrun.flagship_case(str(tmp_path / "c.pt"), 2,
                                dataset=str(tmp_path / "kitti"))
    whole = dryrun.dataset_block(case, None)
    assert whole.shape == (2 * dryrun.FLAGSHIP_ROWS, 375, 1242, 3)
    assert whole.dtype == torch.uint8
    pos = torch.from_numpy(case["batch"][0])
    for rank in range(2):
        dp = DataParallel(rank=rank, world=2, device=torch.device("cpu"),
                          backend="gloo")
        block = dryrun.dataset_block(case, dp)
        rows = slice(rank * dryrun.FLAGSHIP_ROWS,
                     (rank + 1) * dryrun.FLAGSHIP_ROWS)
        assert torch.equal(block, whole[rows])
        mine = pos[dp.rows(2)]
        assert torch.equal(local_shard_gather(rank, block, mine),
                           torch.index_select(whole, 0, mine.long()))


@pytest.mark.parametrize("part", ["a", "c"])
def test_flagship_on_two_ranks(part, tmp_path):
    """(a) the 1-D device step and (c) the sharded device-dataset step at
    2 ranks, each held to the one-process step, with a finite loss."""
    run = {"a": dryrun.flagship_data_parallel,
           "c": dryrun.flagship_dataset}[part]
    assert np.isfinite(run(str(tmp_path), 2))


def test_flagship_data_spatial_on_four_ranks(tmp_path):
    """(a) on 4 ranks, then (b), 2 ranks of 2 images over 2 height tiles
    each: halo copies on every rank and the loss of (a) to 1e-3."""
    want = dryrun.flagship_data_parallel(str(tmp_path), 4)
    got = dryrun.flagship_data_spatial(str(tmp_path), 4, want)
    assert abs(got - want) < \
        dryrun.FLAGSHIP_LOSS_RTOL * max(1.0, abs(want))


def test_flagship_data_spatial_refuses_a_stray_loss(tmp_path):
    """(b) raises when its loss is more than 1e-3 from the one given."""
    with pytest.raises(AssertionError, match="disagrees"):
        dryrun.flagship_data_spatial(str(tmp_path), 4, 1e6)
