"""The train CLI over two gloo CPU ranks (``--num_devices 2``, spawned
processes): rank 0 writes the events file, ``model_metrics.txt`` and the
checkpoints, each rank its own sampler snapshot; the checkpoint loads in
a one-process run; a resumed two-rank run ends where a straight one
does, bit for bit; the sharded ``--device_dataset`` trains with one
shard of the split per rank; and two ranks on two hosts of one rank each
(torchrun's environment) train the one process's global batch and write
its gradient histograms."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from squeezedet_torch import summary
from squeezedet_torch import train as port_cli
from squeezedet_torch.checkpoint.manager import STATE_FILE, all_steps
from squeezedet_torch.models import get_model
from squeezedet_torch.parallel.distributed import free_port
from synth_kitti import make_synth_kitti


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_dp"))
    make_synth_kitti(root, num_images=8, width=96, height=96)
    return root


def _argv(root, train_dir, max_steps, *extra):
    return ["--device", "cpu", "--data_path", root, "--train_dir",
            str(train_dir), "--image_width", "96", "--image_height", "96",
            "--batch_size", "4", "--max_steps", str(max_steps),
            "--checkpoint_step", "2", "--summary_step", "2",
            "--device_assign", "--uint8_ingest", *extra]


def _state(train_dir, step):
    return torch.load(os.path.join(str(train_dir), "model.ckpt-{}".format(
        step), STATE_FILE), map_location="cpu", weights_only=True)


def _sampler(train_dir, step, rank):
    with np.load(os.path.join(str(train_dir), "sampler.ckpt-{}.p{}.npz"
                              .format(step, rank))) as f:
        return dict(f)


def test_two_rank_cli_writes_resumes_and_loads_in_one_process(
        kitti_root, tmp_path, capfd):
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    dp = ["--num_devices", "2", "--device_augment"]
    assert port_cli.main(_argv(kitti_root, straight, 4, *dp)) is None
    port_cli.main(_argv(kitti_root, resumed, 2, *dp))
    port_cli.main(_argv(kitti_root, resumed, 4, *dp))
    out = capfd.readouterr().out
    assert out.count("backend gloo (CPU ranks)") == 6
    assert "Resumed from step 2" in out

    # rank 0 writes the job's files; every rank its own snapshot
    assert len(glob.glob(str(straight / "events.out.tfevents*"))) == 1
    assert os.path.isfile(straight / "model_metrics.txt")
    assert all_steps(str(straight)) == [0, 2, 3]
    names = sorted(os.listdir(straight))
    for step in (0, 2, 3):
        assert ["sampler.ckpt-{}.p{}.npz".format(step, r) for r in (0, 1)] \
            == [n for n in names if n.startswith(
                "sampler.ckpt-{}.".format(step))]

    # the resumed run ends where the straight one does
    a, b = _state(straight, 3), _state(resumed, 3)
    assert a["step"] == b["step"] == 4
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
    for name, t in a["opt_state"]["momentum"].items():
        assert torch.equal(t, b["opt_state"]["momentum"][name]), name
    for rank in (0, 1):
        x, y = _sampler(straight, 3, rank), _sampler(resumed, 3, rank)
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    # every rank draws the same global plan: equal snapshots
    x, y = _sampler(straight, 3, 0), _sampler(straight, 3, 1)
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)

    # the two-rank checkpoint loads in a one-process run
    state = port_cli.main(_argv(kitti_root, straight, 5, "--device_augment"))
    assert state.step == 5
    assert "Resumed from step 4" in capfd.readouterr().out


def test_two_rank_sharded_device_dataset(kitti_root, tmp_path, capfd):
    """Each rank holds its shard of the split; the snapshots carry the
    two shards' permutations, alike on both ranks."""
    train_dir = tmp_path / "dd"
    port_cli.main(_argv(kitti_root, train_dir, 2, "--num_devices", "2",
                        "--device_dataset"))
    out = capfd.readouterr().out
    assert "(shard 0 of 2)" in out and "(shard 1 of 2)" in out
    losses = [float(line.rsplit("loss = ", 1)[1].split()[0])
              for line in out.splitlines() if "loss = " in line]
    assert len(losses) == 1 and np.isfinite(losses[0])
    snaps = [_sampler(train_dir, 1, r) for r in (0, 1)]
    assert snaps[0]["shard_perm_order"].shape == (2, 4)
    for k in snaps[0]:
        np.testing.assert_array_equal(snaps[0][k], snaps[1][k], err_msg=k)
    # rank 0 also draws the summary step's detection images (one forward)
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("data-parallel ranks ")]
    ranks = json.loads(line.split(" ", 2)[2])
    assert [(r["steps"], r["forwards"], r["k1"], r["k2"]) for r in ranks] \
        == [(2, 3, 0, 0), (2, 2, 0, 0)]


class _Recorder:
    """A SummaryWriter that keeps the histograms and saves them to
    ``hist.pt`` in its log directory when closed."""
    enabled = True

    def __init__(self, logdir):
        self.path = os.path.join(logdir, "hist.pt")
        self.hist = {}

    def histogram(self, tag, values, step, buckets=None):
        self.hist["{}@{}".format(tag, step)] = torch.from_numpy(
            np.array(values))

    def scalar(self, *args):
        pass

    def image(self, *args, **kwargs):
        pass

    def close(self):
        torch.save(self.hist, self.path)


def _host_rank(rank, port, argv):
    """Rank ``rank`` of a job of two hosts with one rank each, in the
    environment torchrun gives it (``LOCAL_WORLD_SIZE`` 1)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    summary.SummaryWriter = _Recorder
    port_cli.main(argv)


def test_two_hosts_train_the_global_batch_and_its_histograms(
        kitti_root, tmp_path, monkeypatch, capfd):
    """``--batch_size`` is the global batch across hosts too: the two
    one-rank hosts' checkpoint is the one process's within 1e-4 of each
    leaf's largest update plus the f32 spacing of its largest weight
    (dropout on; the per-rank sums, in other orders, may round the last
    bit of a weight whose update is small), and a per-rank batch would
    be off by a whole update.  Rank 0's gradient histograms, of the
    global batch's
    gradient, are the one process's within 1e-4 of their largest value
    plus 1e-9."""
    import torch.multiprocessing as mp
    hosts, one = tmp_path / "hosts", tmp_path / "one"
    flags = ["--histogram_step", "1", "--device_augment"]
    mp.start_processes(_host_rank, args=(free_port(), _argv(
        kitti_root, hosts, 2, *flags)), nprocs=2, join=True,
        start_method="spawn")
    monkeypatch.setattr(summary, "SummaryWriter", _Recorder)
    port_cli.main(_argv(kitti_root, one, 2, "--num_devices", "1", *flags))
    assert capfd.readouterr().out.count(
        "rank 0 of 2 on cpu, backend gloo (CPU ranks)") == 1

    args = port_cli.build_arg_parser().parse_args(_argv(kitti_root, one, 2))
    init = get_model("squeezeDet", port_cli.config_from_args(args),
                     device="cpu", generator=torch.Generator().manual_seed(
                         args.seed)).backbone.state_dict()
    got, want = _state(hosts, 1), _state(one, 1)
    assert got["step"] == want["step"] == 2
    for name, w in want["params"].items():
        bound = 1e-4 * float((w - init[name]).abs().max()) + \
            float(np.spacing(w.abs().max().numpy()))
        assert float((got["params"][name] - w).abs().max()) <= bound, name

    got = torch.load(hosts / "hist.pt", weights_only=True)
    want = torch.load(one / "hist.pt", weights_only=True)
    assert set(got) == set(want)
    assert "gradients/conv12/bias@1" in want
    for tag, w in want.items():
        bound = 1e-4 * float(w.abs().max()) + 1e-9
        assert float((got[tag] - w).abs().max()) <= bound, tag
