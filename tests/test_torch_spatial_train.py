"""The port's data x spatial train step on the CPU (``trainer.py``,
``spatial=``; ``parallel/dryrun.py``'s 2-D check), against the port's
unsharded step and the JAX package's single-device step.

Tolerances are ``tests/test_spatial.py``'s (lines 113-185): loss terms
to rtol 1e-5, every parameter to rtol 1e-4 and atol 1e-6.  The JAX
comparison runs at ``keep_prob=1`` (the two frameworks draw different
dropout bits from a seed); the port's own comparisons keep dropout on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from squeezedet_torch.models import layers as TL
from squeezedet_torch.models.skeleton import Targets
from squeezedet_torch.ops import filter_grad as fg
from squeezedet_torch.parallel import dryrun
from squeezedet_torch.parallel.mesh import make_mesh_2d, make_mesh_spatial
from squeezedet_torch.trainer import (make_train_step, make_train_step_device,
                                      make_train_step_device_scan)
from squeezedet_torch.weights import from_jax_params
from squeezedet_tpu import trainer as JT
from squeezedet_tpu.models.skeleton import Targets as JaxTargets
from test_torch_dispatch import (_port_state, _stacked, _torch,
                                 start)  # noqa: F401

STEPS = 3


@pytest.fixture
def one_thread():
    """The test's torch ops on one thread: the tensors are small, and in
    a run of several test processes on the same cores more threads only
    contend.  The scan test keeps torch's default: its batch sits on a
    knife edge of the loss (a 1e-7 relative nudge of the unsharded
    input moves fire9.expand3x3's gradient by 0.57 %), so it holds only
    where the CPU's tiled forward equals the unsharded one bit for bit,
    as it does at the default thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy_targets(batch, anchors, classes, rng):
    """``tests/test_spatial.py``'s targets: anchor 3 of each image owns a
    class-1 box."""
    mask = np.zeros((batch, anchors), np.float32)
    labels = np.zeros((batch, anchors, classes), np.float32)
    mask[:, 3] = 1.0
    labels[:, 3, 1] = 1.0
    return (mask, rng.randn(batch, anchors, 4).astype(np.float32) * .1,
            np.full((batch, anchors, 4), 30.0, np.float32), labels)


def _assert_params_close(got, want):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_spatial_train_matches_single_device(start, one_thread):
    """3 steps over (1, 4): one data coordinate, the height over 4 tiles
    (the 6-row grid split 1, 2, 1, 2), in one process, against the
    port's unsharded steps and the JAX package's single-device
    ``make_train_step`` from the same weights and optimizer state."""
    jdet, tx, params, opt_state = start
    cfg = jdet.cfg
    rng = np.random.RandomState(0)
    images = rng.randn(cfg.batch_size, 96, 96, 3).astype(np.float32)
    targets = _toy_targets(cfg.batch_size, cfg.anchors, cfg.classes, rng)

    jstep = JT.make_train_step(jdet, tx, donate=False)
    p, o, want = params, opt_state, []
    for k in range(STEPS):
        p, o, lb = jstep(p, o, jnp.asarray(images),
                         JaxTargets(*map(jnp.asarray, targets)),
                         jax.random.key(100 + k))
        want.append(float(lb.total))
    want_params = from_jax_params(jax.tree.map(np.asarray, p))

    tiling = make_mesh_2d(1, 4, "cpu").tiling()
    for spatial in (None, tiling):
        state = _port_state(start)
        step = make_train_step(state, spatial=spatial)
        got = [float(step(torch.from_numpy(images),
                          Targets(*map(torch.from_numpy, targets))).total)
               for _ in range(STEPS)]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        _assert_params_close(state.det.backbone.state_dict(), want_params)


def test_spatial_train_with_dropout_matches_unsharded(start, one_thread):
    """The same over (1, 4) and a 2x2 height x width grid with dropout
    on: each tile keeps its part of the whole frame's mask, so the steps
    follow the unsharded ones under the same generator."""
    _, stacked = _stacked(np.random.RandomState(1), "uint8_ingest",
                             STEPS)

    def run(spatial):
        state = _port_state(start, keep_prob=0.5)
        step = make_train_step_device(state, uint8_ingest=True,
                                      spatial=spatial)
        gen = torch.Generator().manual_seed(3)
        lbs = [torch.stack(list(step(*(torch.from_numpy(x[i])
                                       for x in stacked), generator=gen)))
               for i in range(STEPS)]
        return torch.stack(lbs), state.det.backbone.state_dict()
    want, want_params = run(None)
    for grid in [(4, 1), (2, 2)]:
        got, got_params = run(make_mesh_spatial(*grid,
                                                device="cpu").tiling())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        _assert_params_close(got_params, want_params)


def test_data_x_spatial_step_over_two_gloo_ranks(one_thread):
    """``make_mesh_2d(2, 2)``: two gloo CPU ranks, each on its half of the
    global batch of 4 over 2 height tiles, with dropout on, against the
    unsharded one-process step (``parallel/dryrun.py``'s tolerances)."""
    assert np.isfinite(dryrun.run(2, 2))


def test_scan_over_2x2_tiles_matches_unsharded_scan(start):
    """K=2 scanned steps over a 2x2 tiling against the unsharded scan
    (``test_scan_dispatch_on_2d_mesh``'s tolerances), dropout on.  The
    2x2 here is height x width in one process; the JAX test's (2 data x
    2 spatial) mesh is two gloo ranks of 2 height tiles each in the port
    (``tests/test_torch_gloo_scan.py``)."""
    _, stacked = _stacked(np.random.RandomState(2), "uint8_ingest", 2)
    stacked = _torch(stacked)

    def run(spatial):
        state = _port_state(start, keep_prob=0.5)
        lbs = make_train_step_device_scan(
            state, 2, uint8_ingest=True, spatial=spatial)(
                *stacked, generator=torch.Generator().manual_seed(4))
        return lbs.total, state.det.backbone.state_dict()
    want, want_params = run(None)
    got, got_params = run(make_mesh_spatial(2, 2, device="cpu").tiling())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    _assert_params_close(got_params, want_params)


def test_filter_grad_is_ignored_on_a_spatial_mesh(start, monkeypatch,
                                                  capsys, one_thread):
    """With K2 routing on, the unsharded step routes weight gradients
    through K2's wrapper; over a 2-tile mesh the JAX trainer's warning is
    printed, no call reaches K2 and the step equals the step with the
    routing off."""
    calls = []
    plain = fg.filter_grad
    monkeypatch.setattr(fg, "filter_grad",
                        lambda *a: calls.append(1) or plain(*a))
    _, stacked = _stacked(np.random.RandomState(3), "uint8_ingest", 1)
    batch = [torch.from_numpy(x[0]) for x in stacked]
    tiling = make_mesh_2d(1, 2, "cpu").tiling()

    def step(mode, spatial):
        state = _port_state(start)
        TL.set_filter_grad(mode)
        try:
            lb = make_train_step_device(state, uint8_ingest=True,
                                        spatial=spatial)(*batch)
        finally:
            TL.set_filter_grad(False)
        return lb, state.det.backbone.state_dict()
    step(True, None)
    assert calls and "WARNING" not in capsys.readouterr().out
    calls.clear()
    got, got_params = step(True, tiling)
    assert not calls
    assert "--pallas_grads is single-device only; ignoring it on a " \
        "2-device mesh." in capsys.readouterr().out
    want, want_params = step(False, tiling)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(got_params[k], want_params[k])
               for k in want_params)


def test_filter_grad_warns_on_a_one_tile_mesh(start, monkeypatch, capsys,
                                              one_thread):
    """A 1x1 tiling runs its convs VALID over the tile window too, so K2
    is dropped there as well, and the warning says so."""
    calls = []
    plain = fg.filter_grad
    monkeypatch.setattr(fg, "filter_grad",
                        lambda *a: calls.append(1) or plain(*a))
    _, stacked = _stacked(np.random.RandomState(3), "uint8_ingest", 1)
    batch = [torch.from_numpy(x[0]) for x in stacked]
    state = _port_state(start)
    TL.set_filter_grad(True)
    try:
        make_train_step_device(state, uint8_ingest=True,
                               spatial=make_mesh_2d(1, 1, "cpu").tiling())(
                                   *batch)
    finally:
        TL.set_filter_grad(False)
    assert not calls
    assert "--pallas_grads is single-device only; ignoring it on a " \
        "1-device mesh." in capsys.readouterr().out
