"""K train steps per dispatch (``--steps_per_dispatch``) in the port, on
the CPU, where :func:`make_train_step_device_scan` runs the K steps one
after another (the plain version of the card's captured graph).

K scanned steps equal K single steps (dropout on) and, with
``keep_prob=1``, the JAX package's ``make_train_step_device_scan`` on
the same weights, optimizer state and stacked batches, for each ingest
variant, to the tolerance ``test_torch_train.py`` holds one step to.
Then the rates inside a dispatch, the train loop's dispatches with an
odd tail, their checkpoints and resume, the CLI flag, and the refusals
(K > 1 over gloo ranks runs: ``tests/test_torch_gloo_scan.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import train as port_cli
from squeezedet_torch.checkpoint.manager import latest_step
from squeezedet_torch.data.kitti import Kitti
from squeezedet_torch.optim import Momentum, build_optimizer, learning_rate_at
from squeezedet_torch.trainer import (TrainState, make_train_step_device,
                                      make_train_step_device_scan, train)
from squeezedet_torch.weights import from_jax_opt_state, from_jax_params
from squeezedet_tpu import trainer as JT
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.data.device_pipeline import (
    augment_resize_normalize as jax_augment)
from squeezedet_tpu.models import get_model as jax_get_model
from squeezedet_tpu.optim import build_optimizer as jax_build_optimizer
from synth_kitti import make_synth_kitti

K = 3
CFG_KW = dict(keep_prob=1.0, lr_warmup_steps=8, learning_rate=0.01)
VARIANTS = ["uint8_ingest", "device_augment", "device_dataset"]
DATASET_ROWS = 5


@pytest.fixture(scope="module")
def start():
    """JAX params with random biases and a 0.05 head, and a mid-training
    optax state (a random trace, step 5), as test_torch_train.py builds
    them."""
    jdet = jax_get_model("squeezeDet", tiny_test_config().replace(**CFG_KW))
    params, mask, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)

    def perturb(path, p):
        if path[-1].key == "bias":
            return jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.1)
        if path[0].key == "conv12":
            return jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.05)
        return p
    params = jax.tree_util.tree_map_with_path(perturb, params)
    tx = jax_build_optimizer(jdet.cfg, mask)
    like = tx.init(params)
    trace = jax.tree.map(
        lambda p, m: jnp.asarray(rng.randn(*p.shape).astype(np.float32)
                                 * 1e-3) if m else jnp.zeros_like(p),
        params, mask)
    opt_state = (like[0], like[1], like[2]._replace(trace=trace),
                 like[3]._replace(count=jnp.asarray(5, jnp.int32)))
    return jdet, tx, params, opt_state


def _port_state(start, **cfg_kw):
    _, _, params, opt_state = start
    det = st.get_model("squeezeDet", st.tiny_test_config().replace(
        **dict(CFG_KW, **cfg_kw)), device="cpu")
    det.backbone.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params)))
    opt = build_optimizer(det.cfg, det)
    opt.load_state_dict(from_jax_opt_state(opt_state, det.trainable_mask()))
    return TrainState(det, opt)


def _stacked(rng, variant, k=K):
    """(head, stacked inputs) of k steps of B=2: uint8 images, or raw
    canvases with augment rows, or canvas rows of a dataset stack."""
    K, b, g = k, 2, 4
    boxes = np.stack([rng.uniform(15, 80, (K, b, g)),
                      rng.uniform(15, 80, (K, b, g)),
                      rng.uniform(10, 40, (K, b, g)),
                      rng.uniform(10, 40, (K, b, g))],
                     axis=-1).astype(np.float32)
    labels = rng.randint(0, 3, (K, b, g)).astype(np.int32)
    num_gt = rng.randint(1, g + 1, (K, b)).astype(np.int32)
    targets = [boxes, labels, num_gt]
    if variant == "uint8_ingest":
        return [], [rng.randint(0, 256, (K, b, 96, 96, 3)).astype(
            np.uint8)] + targets
    dx, dy = rng.randint(-6, 7, (K, b)), rng.randint(-6, 7, (K, b))
    aug = np.stack([dx, dy, rng.randint(0, 2, (K, b)), 120 - dx, 110 - dy],
                   axis=-1).astype(np.float32)
    if variant == "device_augment":
        return [], [rng.randint(0, 256, (K, b, 110, 120, 3)).astype(
            np.uint8), aug] + targets
    dataset = rng.randint(0, 256, (DATASET_ROWS, 110, 120, 3)).astype(
        np.uint8)
    pos = rng.randint(0, DATASET_ROWS, (K, b)).astype(np.int32)
    return [dataset], [pos, aug] + targets


def _flags(variant):
    return dict(uint8_ingest=True,
                device_augment=variant != "uint8_ingest",
                device_dataset=variant == "device_dataset")


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("variant", VARIANTS)
def test_scanned_steps_equal_single_steps_with_dropout(start, variant):
    """K scanned steps are K single steps, bit for bit, with dropout on:
    the same losses, parameters, momentum, optimizer step and generator
    state."""
    head, stacked = _stacked(np.random.RandomState(7), variant)
    head, stacked = _torch(head), _torch(stacked)
    a, b = (_port_state(start, keep_prob=0.5) for _ in range(2))
    gen_a, gen_b = (torch.Generator().manual_seed(3) for _ in range(2))
    single = make_train_step_device(a, **_flags(variant))
    lbs = [single(*head, *(x[i] for x in stacked), generator=gen_a)
           for i in range(K)]
    got = make_train_step_device_scan(b, K, **_flags(variant))(
        *head, *stacked, generator=gen_b)
    for name, t in zip(got._fields, got):
        assert t.shape == (K,)
        assert torch.equal(t, torch.stack([getattr(lb, name) for lb in lbs]))
    assert a.step == b.step == 5 + K
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    for (name, p), q in zip(a.det.backbone.state_dict().items(),
                            b.det.backbone.state_dict().values()):
        assert torch.equal(p, q), name
    for name, t in a.opt.trace.items():
        assert torch.equal(t, b.opt.trace[name]), name


def _jax_pixels(cfg, head, stacked, variant):
    """The JAX package's ``augment_resize_normalize`` of each step's
    canvas rows, evaluated op by op as written: [K, B, H, W, 3] f32."""
    canvases = stacked[0] if variant == "device_augment" else \
        head[0][stacked[0]]
    return np.stack([np.asarray(jax_augment(
        jnp.asarray(c), jnp.asarray(a), cfg.image_height, cfg.image_width,
        cfg.bgr_means)) for c, a in zip(canvases, stacked[1])])


@pytest.mark.parametrize("variant", VARIANTS)
def test_scanned_steps_match_jax_scan(start, variant):
    """keep_prob=1: the port's K scanned steps against the JAX package's
    ``make_train_step_device_scan`` from the same weights, optimizer
    state and stacked batches.  Loss terms to rtol 1e-4; each parameter
    within 1e-3 of that leaf's largest move plus 1e-9, each momentum leaf
    within 1e-3 of its largest value plus 1e-9.

    Under the on-device augment the JAX scan is given the JAX package's
    augment of each step's rows as f32 images: inside a jitted program
    XLA evaluates the two resampling contractions up to 3e-3 px away
    from their own op-by-op result (2 ulps from the port's), and three
    steps at this learning rate carry that to 24 % of fire2.expand1x1's
    move, JAX against itself.  The JAX scan with the augment inside
    agrees with the port's first step to the same rtol."""
    jdet, tx, params, opt_state = start
    head, stacked = _stacked(np.random.RandomState(8), variant)
    keys = jax.random.split(jax.random.key(0), K)
    flags = _flags(variant)
    scan = JT.make_train_step_device_scan(jdet, tx, K, donate=False,
                                          **flags)
    new_params, new_opt, want = scan(
        params, opt_state, *map(jnp.asarray, head + stacked), keys)
    first = [np.asarray(t)[0] for t in want]
    if flags["device_augment"]:
        pixels = _jax_pixels(jdet.cfg, head, stacked, variant)
        scan = JT.make_train_step_device_scan(jdet, tx, K, donate=False)
        new_params, new_opt, want = scan(
            params, opt_state, jnp.asarray(pixels),
            *map(jnp.asarray, stacked[-3:]), keys)

    state = _port_state(start)
    before = {n: p.clone() for n, p in state.det.backbone.state_dict()
              .items()}
    got = make_train_step_device_scan(state, K, **flags)(
        *_torch(head), *_torch(stacked))
    np.testing.assert_allclose([t[0].item() for t in got], first, rtol=1e-4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    want_p = from_jax_params(jax.tree.map(np.asarray, new_params))
    for name, p in state.det.backbone.state_dict().items():
        moved = (want_p[name] - before[name]).abs().max()
        err = (p - want_p[name]).abs().max()
        assert err <= 1e-3 * moved + 1e-9, (name, float(err), float(moved))
    want_m = from_jax_opt_state(new_opt, state.det.trainable_mask())
    assert want_m["step"] == state.step == 5 + K
    for name, t in state.opt.trace.items():
        ref = want_m["momentum"][name]
        err = (t - ref).abs().max()
        assert err <= 1e-3 * ref.abs().max() + 1e-9, (name, float(err))


def test_rates_inside_a_dispatch_cross_warmup_and_decay(start, monkeypatch):
    """A dispatch of 4 steps from step 5 crosses the warm-up's end (step
    6) and a decay boundary (step 8): the rate each step updates with is
    ``learning_rate_at`` of its step, and the trajectory is that of 4
    single steps."""
    kw = dict(lr_warmup_steps=7, decay_steps=8, lr_decay_factor=0.5)
    cfg = st.tiny_test_config().replace(**dict(CFG_KW, **kw))
    head, stacked = _stacked(np.random.RandomState(9), "uint8_ingest", 4)
    stacked = _torch(stacked)
    a, b = _port_state(start, **kw), _port_state(start, **kw)
    rates = b.opt.dispatch_rates(4)
    np.testing.assert_allclose(
        rates, [learning_rate_at(cfg, s) for s in range(5, 9)], rtol=1e-6)
    assert rates[1] > rates[0] and rates[3] < rates[2]  # warm-up, decay
    used = []
    real = Momentum.update

    def spy(self, neg_lr=None):
        used.append(-float(neg_lr))
        return real(self, neg_lr)
    single = make_train_step_device(a, uint8_ingest=True)
    for i in range(4):
        single(*(x[i] for x in stacked))
    monkeypatch.setattr(Momentum, "update", spy)
    make_train_step_device_scan(b, 4, uint8_ingest=True)(*stacked)
    assert used == [float(r) for r in rates]
    for (name, p), q in zip(a.det.backbone.state_dict().items(),
                            b.det.backbone.state_dict().values()):
        assert torch.equal(p, q), name


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_dispatch"))
    make_synth_kitti(root, num_images=5, width=96, height=96)
    return root


def _det(keep_prob=0.5):
    cfg = st.tiny_test_config().replace(keep_prob=keep_prob, batch_size=2,
                                        data_augmentation=True, drift_x=10,
                                        drift_y=10)
    return st.get_model("squeezeDet", cfg, device="cpu",
                        generator=torch.Generator().manual_seed(4))


def _train(kitti_root, train_dir, max_steps, **kw):
    det = _det()
    imdb = Kitti("train", kitti_root, det.cfg, rng=np.random.RandomState(0))
    kw = dict(dict(checkpoint_step=1000, summary_step=1000, log_every=1,
                   device_assign=True, uint8_ingest=True, device_augment=True,
                   steps_per_dispatch=2), **kw)
    return train(det, imdb, train_dir=str(train_dir), max_steps=max_steps,
                 **kw)


def test_loop_checkpoints_at_dispatch_boundaries_and_resumes(kitti_root,
                                                              tmp_path):
    """K=2 to step 5 with a checkpoint every 2 steps: dispatches [0, 1],
    [2, 3] and the single-step tail [4]; the latest checkpoint is step 4
    with its sampler file, and a resume runs to step 6."""
    train_dir = tmp_path / "train"
    state = _train(kitti_root, train_dir, 5, checkpoint_step=2)
    assert state.step == 5
    assert latest_step(str(train_dir)) == 4
    assert os.path.exists(train_dir / "sampler.ckpt-4.npz")
    assert _train(kitti_root, train_dir, 6).step == 6


def test_resumed_dispatch_run_equals_a_straight_one(kitti_root, tmp_path):
    """K=2 with dropout: a run to step 3 (one dispatch and a tail step,
    then a checkpoint) resumed to step 7 ends where a straight run to
    step 7 ends, bit for bit: parameters, momentum and the input stream
    and dropout generator picked up where they stopped."""
    straight = _train(kitti_root, tmp_path / "straight", 7)
    _train(kitti_root, tmp_path / "split", 3)
    resumed = _train(kitti_root, tmp_path / "split", 7)
    assert straight.step == resumed.step == 7
    for (name, p), q in zip(straight.det.backbone.state_dict().items(),
                            resumed.det.backbone.state_dict().values()):
        assert torch.equal(p, q), name
    for name, t in straight.opt.trace.items():
        assert torch.equal(t, resumed.opt.trace[name]), name


def test_cli_runs_dispatches_of_k(kitti_root, tmp_path, capsys):
    """``--steps_per_dispatch 2`` reaches the loop: 3 steps run as one
    dispatch and a tail, and the per-step summaries it skips are named in
    one warning, as the JAX CLI names them."""
    state = port_cli.main([
        "--device", "cpu", "--data_path", kitti_root, "--train_dir",
        str(tmp_path / "cli"), "--image_width", "96", "--image_height", "96",
        "--batch_size", "2", "--max_steps", "3", "--device_assign",
        "--uint8_ingest", "--device_dataset", "--steps_per_dispatch", "2",
        "--histogram_step", "1", "--summary_step", "1"])
    assert state.step == 3
    out = capsys.readouterr().out
    assert out.count("WARNING: steps_per_dispatch=2") == 1
    assert "--summary_step viz images, --histogram_step" in out
    assert "sec/2-step dispatch" in out


def test_refusals(start, kitti_root, tmp_path):
    """K > 1 needs the on-device matcher (the JAX package's words), and
    each input must stack K steps."""
    state = _port_state(start)
    with pytest.raises(ValueError, match="requires --device_assign"):
        train(state.det, None, train_dir=str(tmp_path), max_steps=1,
              steps_per_dispatch=2)
    with pytest.raises(ValueError, match="stack 2 steps"):
        make_train_step_device_scan(state, 2)(*_torch(_stacked(
            np.random.RandomState(0), "uint8_ingest")[1]))
