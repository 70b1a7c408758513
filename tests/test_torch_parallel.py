"""The port's data parallelism on the CPU, against the JAX package and
against itself:

* the sharded sampling plans (``shard_hosts``, ``shard_data``, the
  per-shard sampler state, ``eval_shard_batches``,
  ``load_canvas_shards``) equal the JAX package's array for array, and
  the refusals the reference lacks (a batch that does not divide the
  effective batch, data-axis owners out of process order) hold;
* a two-rank gloo train step (spawned processes) equals the one-process
  step at the same global batch with dropout on (``parallel.dryrun``),
  and with ``keep_prob=1`` the JAX package's step on a 2-device mesh;
* eval over two replicas (f32, int8, sharded ``--device_dataset``) and
  the server over two replicas give one replica's detections;
* the parallel modules and the entry points import no jax.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import eval as port_eval
from squeezedet_torch import serve
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.parallel import dryrun
from squeezedet_torch.parallel import mesh as mesh_mod
from squeezedet_torch.parallel.distributed import DataParallel
from squeezedet_torch.parallel.mesh import local_data_coords, make_mesh
from squeezedet_torch.weights import from_jax_opt_state, from_jax_params
from squeezedet_tpu.config import tiny_test_config as jax_tiny_config
from squeezedet_tpu.data import Kitti as JaxKitti
from squeezedet_tpu.parallel import mesh as jax_mesh
from squeezedet_tpu import trainer as JT
from synth_kitti import make_synth_kitti
from test_torch_train import CFG_KW, _batch, _port_state, start  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = dict(data_augmentation=True, drift_x=20, drift_y=20)
# eval detections of two replicas against one: the f32 forwards of other
# batch sizes may round differently (tests/test_torch_eval.py's bounds)
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """9 images of two sizes (shards of unequal length at D=2 and 4)."""
    root = str(tmp_path_factory.mktemp("kitti_parallel"))
    a = make_synth_kitti(root, num_images=5, width=96, height=96, seed=0)
    b = make_synth_kitti(root, num_images=4, width=100, height=90, seed=1,
                         start_index=5)
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(a + b) + "\n")
    return root


def _pair(root, seed, batch):
    port = Kitti("train", root, st.tiny_test_config().replace(
        batch_size=batch, **AUG), rng=np.random.RandomState(seed))
    ref = JaxKitti("train", root, jax_tiny_config().replace(
        batch_size=batch, **AUG), rng=np.random.RandomState(seed))
    return port, ref


def _assert_plans_equal(a, b):
    assert a.seq == b.seq and a.batch_idx == b.batch_idx
    assert a.augment == b.augment
    _assert_states_equal(a.state, b.state)


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_data_plans_equal_jax(kitti_root, shards):
    """Three epochs of shard-major plans, the sharded sampler state, a
    restored state's continuation, positions and the shard blocks."""
    port, ref = _pair(kitti_root, 3, 4)
    port.shard_data(shards)
    ref.shard_data(shards)
    assert port._shard_rows == ref._shard_rows
    for _ in range(7):
        _assert_plans_equal(port.draw_batch_plan(), ref.draw_batch_plan())
    _assert_states_equal(port.sampler_state(), ref.sampler_state())
    for idx in port.image_idx:
        assert port.dataset_position(idx) == ref.dataset_position(idx)
    np.testing.assert_array_equal(port.load_canvas_dataset(),
                                  ref.load_canvas_dataset())
    for ids in ([0], list(range(shards)), [shards - 1]):
        np.testing.assert_array_equal(port.load_canvas_shards(ids),
                                      ref.load_canvas_shards(ids))
    # a fresh sharded imdb restored from the snapshot continues the stream
    snap = port.sampler_state()
    port2, ref2 = _pair(kitti_root, 99, 4)
    port2.shard_data(shards)
    ref2.shard_data(shards)
    port2.set_sampler_state(snap)
    ref2.set_sampler_state(snap)
    for _ in range(3):
        a, b = port2.draw_batch_plan(), ref2.draw_batch_plan()
        assert a.batch_idx == b.batch_idx == port.draw_batch_plan().batch_idx
        assert a.augment == b.augment


@pytest.mark.parametrize("shards,batch", [(2, 2), (2, 6), (4, 4), (4, 8)])
def test_eval_shard_batches_equal_jax(kitti_root, shards, batch):
    port, ref = _pair(kitti_root, 0, batch)
    port.shard_data(shards)
    ref.shard_data(shards)
    got = list(port.eval_shard_batches(batch))
    want = list(ref.eval_shard_batches(batch))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # every image exactly once
    seen = np.concatenate([g[3] for g in got])
    assert sorted(seen[seen >= 0]) == list(range(len(port.image_idx)))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_shard_hosts_plans_equal_jax(kitti_root, rank):
    port, ref = _pair(kitti_root, 5 + rank, 2)
    port.shard_hosts(rank, 3)
    ref.shard_hosts(rank, 3)
    assert port.image_idx == ref.image_idx
    assert port.canvas_size() == ref.canvas_size() == (96, 100)
    for _ in range(4):
        _assert_plans_equal(port.draw_batch_plan(), ref.draw_batch_plan())


def test_sharding_refusals(kitti_root):
    """The batch must divide the *effective* batch (the JAX package checks
    ``mc.batch_size`` instead); a resharding, a sharded snapshot into an
    unsharded imdb and back, and eval plans without shards are refused;
    data-axis owners must ascend in process order (the JAX package checks
    contiguity only)."""
    port, ref = _pair(kitti_root, 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        port.shard_data(2, batch_size=3)
    ref.shard_data(2)  # its check reads mc.batch_size (4) only
    with pytest.raises(ValueError, match="not divisible"):
        port.shard_data(4, batch_size=6)
    port.shard_data(2)
    port.shard_data(2)  # the same sharding keeps the stream
    with pytest.raises(ValueError, match="already sharded"):
        port.shard_data(4)
    with pytest.raises(ValueError, match="not divisible"):
        next(port.eval_shard_batches(3))
    plain, _ = _pair(kitti_root, 0, 4)
    with pytest.raises(ValueError, match="data-sharded"):
        plain.set_sampler_state(port.sampler_state())
    with pytest.raises(ValueError, match="unsharded"):
        port.set_sampler_state(plain.sampler_state())
    with pytest.raises(ValueError, match="requires shard_data"):
        next(plain.eval_shard_batches(2))
    with pytest.raises(ValueError, match="requires shard_data"):
        plain.load_canvas_shards([0])

    assert local_data_coords([0, 0, 1, 1], 1) == [2, 3]
    assert local_data_coords(range(4), 2) == [2]
    with pytest.raises(ValueError, match="process order"):
        local_data_coords([1, 1, 0, 0], 0)
    with pytest.raises(ValueError, match="process order"):
        local_data_coords([0, 1, 0, 1], 0)
    with pytest.raises(ValueError, match="owns no coordinate"):
        local_data_coords([0, 0], 1)


def test_rank_rows_and_global_batch():
    """``--batch_size`` is the global batch in every layout: each rank
    takes its share of it, wherever the ranks run, and a batch that
    does not divide over the ranks is refused."""
    cpu = torch.device("cpu")
    one_host = DataParallel(1, 2, cpu, "gloo")
    assert one_host.rows(6) == slice(3, 6)
    with pytest.raises(ValueError, match="not divisible"):
        one_host.rows(5)
    hosts = DataParallel(3, 4, cpu, "gloo")
    assert hosts.rows(8) == slice(6, 8)
    with pytest.raises(ValueError, match="not divisible"):
        hosts.rows(6)
    assert make_mesh(3, "cpu") == [cpu] * 3
    assert mesh_mod.make_mesh_2d(2, 2, "cpu").devices == ((cpu,) * 2,) * 2
    assert (mesh_mod.make_mesh_spatial(2, 2, device="cpu").tiling().devices
            == (cpu,) * 4)


def test_two_ranks_equal_one_process_with_dropout():
    """``parallel.dryrun``: two gloo CPU ranks, each on half of a global
    batch of 4 with dropout on, against the one-process step with K2's
    plain version off and on: loss terms to rtol 1e-5, each parameter and
    momentum leaf within 1e-4 of its largest update (value) plus 1e-9."""
    assert (dryrun.LOSS_RTOL, dryrun.STEP_RTOL, dryrun.STEP_ATOL) == \
        (1e-5, 1e-4, 1e-9)
    assert np.isfinite(dryrun.run(2))


@pytest.mark.parametrize("augment", [False, True],
                         ids=["uint8_ingest", "device_augment"])
def test_two_ranks_match_jax_mesh_step(start, augment, tmp_path):  # noqa: F811
    """With keep_prob=1, two gloo ranks (one image each) against the JAX
    package's step on a 2-device CPU mesh, from the same weights and
    mid-training optimizer state, within test_train_step_matches_jax's
    tolerances."""
    jdet, tx, params, opt_state = start
    batch = _batch(np.random.RandomState(2), augment)
    mesh = jax_mesh.make_mesh(2)
    rep, data = jax_mesh.replicated_sharding(mesh), \
        jax_mesh.batch_sharding(mesh)
    step = JT.make_train_step_device(jdet, tx, mesh=mesh, donate=False,
                                     uint8_ingest=True,
                                     device_augment=augment)
    new_params, new_opt, want = step(
        jax.device_put(params, rep), jax.device_put(opt_state, rep),
        jax.device_put(batch[0], jax_mesh.image_sharding(mesh)),
        *(jax.device_put(jnp.asarray(x), data) for x in batch[1:]),
        jax.random.key(0))

    state = _port_state(start)
    before = {n: p.detach().clone()
              for n, p in state.det.backbone.state_dict().items()}
    path = str(tmp_path / "case.pt")
    dryrun.write_case(path, state.det, batch,
                      opt_state=state.opt.state_dict(),
                      device_augment=augment)
    results = dryrun.step_on_ranks(path, str(tmp_path / "out"), 2)
    for got in results:
        assert got["step"] == 6
        np.testing.assert_allclose(got["loss"].numpy(),
                                   [float(v) for v in want], rtol=1e-4)
        want_p = from_jax_params(jax.tree.map(np.asarray, new_params))
        for name, p in got["params"].items():
            moved = (want_p[name] - before[name]).abs().max()
            err = (p - want_p[name]).abs().max()
            assert err <= 1e-3 * moved + 1e-9, (name, float(err),
                                                float(moved))
        want_m = from_jax_opt_state(new_opt, state.det.trainable_mask())
        for name, t in got["momentum"].items():
            ref = want_m["momentum"][name]
            assert (t - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-9, \
                name
    # both ranks hold one state
    for name, p in results[0]["params"].items():
        assert torch.equal(p, results[1]["params"][name]), name


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_eval_dp"))
    make_synth_kitti(root, num_images=7, width=160, height=96,
                     image_set="val")
    det = st.get_model("squeezeDet", st.tiny_test_config(
        image_width=160, image_height=96, batch_size=4), device="cpu",
        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # spread the scores of the 1e-4 head
        det.backbone.conv12.weight.mul_(500.0)
    return root, det


def _assert_same_detections(got, want):
    assert len(got) == len(want)
    for c in range(len(want)):
        for i in range(len(want[c])):
            a = np.asarray(sorted(map(tuple, want[c][i])))
            b = np.asarray(sorted(map(tuple, got[c][i])))
            assert a.shape == b.shape, (c, i)
            if a.size:
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["f32", "int8", "device_dataset"])
def test_eval_over_two_replicas_equals_one(eval_setup, mode):
    root, det = eval_setup
    kw = dict(device_postprocess=True,
              device_dataset=mode == "device_dataset")
    model = det
    if mode == "int8":
        model = port_eval.quantize_on_split(
            det, Kitti("val", root, det.cfg), 2)
    want, want_n, _ = port_eval.detect_all(
        model, Kitti("val", root, det.cfg), 4, **kw)
    got, got_n, timers = port_eval.detect_all(
        model, Kitti("val", root, det.cfg), 4, mesh=make_mesh(2, "cpu"),
        **kw)
    assert got_n == want_n > 0
    _assert_same_detections(got, want)
    # the sharded plan pads 4 + 3 images to 2 batches of 2 per replica
    assert timers["im_detect"].calls == 2


def test_eval_cli_mesh():
    """--num_devices: 0 takes the visible devices that divide the batch
    (one CPU: no mesh); N > 1 replicas must divide the batch."""
    def mesh(*flags):
        args = port_eval.build_arg_parser().parse_args(list(flags))
        return port_eval.resolve_mesh(args, torch.device("cpu"))
    assert mesh("--eval_batch_size", "8") is None
    assert mesh("--eval_batch_size", "8", "--num_devices", "1") is None
    assert mesh("--eval_batch_size", "8", "--num_devices", "2") == \
        [torch.device("cpu")] * 2
    with pytest.raises(SystemExit, match="not divisible"):
        mesh("--eval_batch_size", "3", "--num_devices", "2")


def test_serving_over_two_replicas_equals_one():
    """``--num_devices 2`` serves each micro-batch over two replicas, and
    gives one replica's replies."""
    cfg = st.tiny_test_config()
    flags = ["--device", "cpu", "--compute_dtype", "float32",
             "--max_batch", "4"]
    one, _ = serve._build_from_checkpoint(
        serve.build_arg_parser().parse_args(flags), cfg)
    two, _ = serve._build_from_checkpoint(serve.build_arg_parser()
                                          .parse_args(flags + [
                                              "--num_devices", "2"]), cfg)
    u8 = np.random.RandomState(3).randint(0, 256, (4, 96, 96, 3), np.uint8)
    for g, w in zip(two(u8), one(u8)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_parallel_modules_import_no_jax():
    code = ("import sys; import squeezedet_torch.parallel, "
            "squeezedet_torch.parallel.dryrun, squeezedet_torch.trainer, "
            "squeezedet_torch.eval, squeezedet_torch.serve, "
            "squeezedet_torch.serving, squeezedet_torch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'squeezedet_tpu')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
