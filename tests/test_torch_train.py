"""One train step of the port against the JAX package on the CPU, and
the port's dropout.

The step is ``make_train_step_device`` at the tiny config from the same
weights, the same mid-training optimizer state (through the opt-state
bridge) and the same batch, with ``keep_prob=1`` (the two frameworks
draw different dropout bits from a seed), for both ingest variants and
with the filter-gradient routing on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch.data.device_pipeline import ingest_and_assign
from squeezedet_torch.models import layers as TL
from squeezedet_torch.ops import filter_grad as fg
from squeezedet_torch.optim import build_optimizer
from squeezedet_torch.trainer import (TrainState, make_train_step,
                                      make_train_step_device,
                                      make_train_step_device_scan, train)
from squeezedet_torch.weights import (from_jax_opt_state, from_jax_params,
                                      to_jax_opt_state)
from squeezedet_tpu import trainer as JT
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.models import get_model as jax_get_model
from squeezedet_tpu.models import layers as JL
from squeezedet_tpu.optim import build_optimizer as jax_build_optimizer

CFG_KW = dict(keep_prob=1.0, lr_warmup_steps=8, learning_rate=0.01)


@pytest.fixture(scope="module")
def start():
    """JAX params with random biases and a 0.05 head, and a mid-training
    optax state: a random trace at the trainable leaves, step 5."""
    jdet = jax_get_model("squeezeDet", tiny_test_config().replace(**CFG_KW))
    params, mask, _ = jdet.init(jax.random.key(0))
    rng = np.random.RandomState(1)

    def perturb(path, p):
        name = path[-1].key
        if name == "bias":
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


def _batch(rng, augment):
    b, g = 2, 4
    boxes = np.stack([rng.uniform(15, 80, (b, g)), rng.uniform(15, 80, (b, g)),
                      rng.uniform(10, 40, (b, g)), rng.uniform(10, 40, (b, g))],
                     axis=-1).astype(np.float32)
    labels = rng.randint(0, 3, (b, g)).astype(np.int32)
    num_gt = np.array([3, 1], np.int32)
    if augment:
        images = rng.randint(0, 256, (b, 110, 120, 3)).astype(np.uint8)
        aug = np.array([[6, -4, 1, 100, 96], [-5, 3, 0, 118, 100]],
                       np.float32)
        return [images, aug, boxes, labels, num_gt]
    return [rng.randint(0, 256, (b, 96, 96, 3)).astype(np.uint8), boxes,
            labels, num_gt]


def _jax_step(start, batch, augment, routed):
    jdet, tx, params, opt_state = start
    step = JT.make_train_step_device(jdet, tx, donate=False,
                                     uint8_ingest=True,
                                     device_augment=augment)
    try:
        JL.set_pallas_filter_grad("interpret" if routed else False)
        out = step(params, opt_state, *map(jnp.asarray, batch),
                   jax.random.key(0))
        jax.block_until_ready(out)
    finally:
        JL.set_pallas_filter_grad(False)
    return out


def _port_state(start):
    jdet, _, params, opt_state = start
    det = st.get_model("squeezeDet", st.tiny_test_config().replace(**CFG_KW),
                       device="cpu")
    det.backbone.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params)))
    opt = build_optimizer(det.cfg, det)
    opt.load_state_dict(from_jax_opt_state(opt_state, det.trainable_mask()))
    return TrainState(det, opt)


@pytest.mark.parametrize("routed", [False, True], ids=["autograd", "k2"])
@pytest.mark.parametrize("augment", [False, True],
                         ids=["uint8_ingest", "device_augment"])
def test_train_step_matches_jax(start, augment, routed):
    """Loss terms to rtol 1e-4; each updated param and momentum leaf
    within 1e-3 of that leaf's largest update (momentum: of its largest
    value) plus 1e-9, the f32 noise of two backward passes that sum in
    other orders.  With routing on, K2 (its plain version here) gives the
    12 eligible weight gradients on both sides."""
    rng = np.random.RandomState(2)
    batch = _batch(rng, augment)
    new_params, new_opt, want = _jax_step(start, batch, augment, routed)

    state = _port_state(start)
    before = {n: p.detach().clone()
              for n, p in state.det.backbone.state_dict().items()}
    step = make_train_step_device(state, uint8_ingest=True,
                                  device_augment=augment)
    calls = []
    real = fg.filter_grad

    def spy(*args):
        calls.append(args[2:])
        return real(*args)
    fg.filter_grad = spy
    try:
        TL.set_filter_grad(True if routed else False)
        got = step(*map(torch.from_numpy, batch))
    finally:
        TL.set_filter_grad(False)
        fg.filter_grad = real
    assert len(calls) == (12 if routed else 0)
    assert calls.count((3, 3)) == (2 if routed else 0)
    assert state.step == 6

    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-4)
    want_p = from_jax_params(jax.tree.map(np.asarray, new_params))
    for name, p in state.det.backbone.state_dict().items():
        moved = (want_p[name] - before[name]).abs().max()
        err = (p - want_p[name]).abs().max()
        assert err <= 1e-3 * moved + 1e-9, (name, float(err), float(moved))
    want_m = from_jax_opt_state(new_opt, state.det.trainable_mask())
    assert want_m["step"] == 6
    for name, t in state.opt.trace.items():
        ref = want_m["momentum"][name]
        err = (t - ref).abs().max()
        assert err <= 1e-3 * ref.abs().max() + 1e-9, (name, float(err))
    # and the port's state maps back onto the JAX chain's structure
    back = to_jax_opt_state(state.opt.state_dict(),
                            state.det.backbone.state_dict(), new_opt)
    assert jax.tree.structure(back) == jax.tree.structure(new_opt)


def test_dense_target_step_equals_device_step(start):
    """make_train_step on the matcher's Targets is the same program as
    the device step after ingest: equal losses and params, bit for bit."""
    batch = _batch(np.random.RandomState(3), False)
    a, b = _port_state(start), _port_state(start)
    lb_dev = make_train_step_device(a, uint8_ingest=True)(
        *map(torch.from_numpy, batch))
    images, targets = ingest_and_assign(b.det, *map(torch.from_numpy, batch),
                                        uint8_ingest=True)
    lb = make_train_step(b)(images, targets)
    assert [float(v) for v in lb] == [float(v) for v in lb_dev]
    for (n, p), q in zip(a.det.backbone.state_dict().items(),
                         b.det.backbone.state_dict().values()):
        assert torch.equal(p, q), n


def test_unported_paths_raise(start, tmp_path):
    """What the port leaves out raises, naming its ROADMAP item: rng_impl
    (14, stays out).  The scanned dispatch and activation summaries are
    ported (test_torch_dispatch.py, test_torch_activation_summary.py);
    a dispatch of fewer than one step is refused.  Data parallelism is
    ported: test_torch_parallel.py and
    test_world_one_data_parallel_step_equals_the_plain_step."""
    state = _port_state(start)
    with pytest.raises(ValueError, match=">= 1"):
        make_train_step_device_scan(state, 0)
    with pytest.raises(NotImplementedError, match="item 14"):
        train(state.det, None, train_dir=str(tmp_path), max_steps=1,
              rng_impl="rbg")


@pytest.fixture
def world_of_one(monkeypatch):
    """A one-rank gloo group in this process (torchrun's environment)."""
    from squeezedet_torch.parallel import distributed
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(distributed.free_port())).items():
        monkeypatch.setenv(k, v)
    threads = torch.get_num_threads()
    dp = distributed.init_data_parallel("cpu")
    try:
        yield dp
    finally:
        distributed.shutdown()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("dense", [False, True],
                         ids=["device_targets", "dense_targets"])
def test_world_one_data_parallel_step_equals_the_plain_step(
        start, world_of_one, dense):
    """The data-parallel step of one rank (all-reduced object count and
    gradients, the dropout draw of the global batch, weight decay on rank
    0) is the plain step, bit for bit, with dropout on."""
    batch = list(map(torch.from_numpy, _batch(np.random.RandomState(4),
                                              False)))
    results = []
    for dp in (None, world_of_one):
        state = _port_state(start)
        state.det.backbone.keep_prob = 0.5  # dropout on
        gen = torch.Generator().manual_seed(3)
        if dense:
            images, targets = ingest_and_assign(state.det, *batch,
                                                uint8_ingest=True)
            lb = make_train_step(state, dp)(images, targets, gen)
        else:
            lb = make_train_step_device(state, uint8_ingest=True,
                                        dp=dp)(*batch, generator=gen)
        results.append(([float(v) for v in lb],
                        state.det.backbone.state_dict()))
    (loss_a, params_a), (loss_b, params_b) = results
    assert loss_a == loss_b
    for name, p in params_a.items():
        assert torch.equal(p, params_b[name]), name


def test_dropout_keep_rate_scale_and_determinism():
    """keep_prob 0.5 (q/256 path) and 0.3 (uniform path): the kept share
    is within 4 sigma of keep_prob, kept values are x/keep_prob, and the
    same generator seed gives the same mask; other seeds another."""
    x = torch.rand(64, 8, 8, 32) + 0.5
    for keep in (0.5, 0.3):
        y = TL.dropout(x, keep, torch.Generator().manual_seed(7), True)
        kept = y != 0
        n = x.numel()
        assert abs(kept.float().mean().item() - keep) < 4 * np.sqrt(
            keep * (1 - keep) / n)
        torch.testing.assert_close(y[kept], x[kept] / keep, rtol=0, atol=0)
        again = TL.dropout(x, keep, torch.Generator().manual_seed(7), True)
        other = TL.dropout(x, keep, torch.Generator().manual_seed(8), True)
        assert torch.equal(y, again) and not torch.equal(y, other)
    assert TL.dropout(x, 0.5, None, False) is x
    assert TL.dropout(x, 1.0, None, True) is x
    with pytest.raises(ValueError):
        TL.dropout(x, 0.5, None, True)


def test_train_forward_draws_two_independent_masks():
    """In training the two fire11 halves get independent dropout draws
    from the one generator: a step's preds change with the seed, and
    repeat with it."""
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu")
    x = torch.randn(1, 96, 96, 3) * 50
    with torch.no_grad():
        a = det(x, train=True, generator=torch.Generator().manual_seed(0))
        b = det(x, train=True, generator=torch.Generator().manual_seed(0))
        c = det(x, train=True, generator=torch.Generator().manual_seed(1))
        d = det(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)
