"""The port's optimizer chain and opt-state bridge against the JAX
package's optax chain (``squeezedet_tpu/optim.py``) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch import optim as TO
from squeezedet_torch.weights import (from_jax_opt_state, from_jax_params,
                                      to_jax_opt_state)
from squeezedet_tpu import optim as JO
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.models import get_model as jax_get_model


@pytest.mark.parametrize("warmup", [0, 7])
def test_schedule_matches_jax(warmup):
    """float32 schedules: equal to 1 ulp (pow may round differently)."""
    args = (0.01, 5, 0.5)
    jax_s = JO.staircase_exponential_decay(*args, warmup_steps=warmup)
    port_s = TO.staircase_exponential_decay(*args, warmup_steps=warmup)
    for step in [0, 1, 4, 5, 6, 9, 10, 11, 26]:
        want = np.float32(jax_s(jnp.asarray(step, jnp.int32)))
        got = port_s(step)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)
        cfg = tiny_test_config().replace(
            learning_rate=0.01, decay_steps=5, lr_decay_factor=0.5,
            lr_warmup_steps=warmup)
        np.testing.assert_allclose(TO.learning_rate_at(cfg, step),
                                   JO.learning_rate_at(cfg, step), rtol=0)
        np.testing.assert_allclose(got, TO.learning_rate_at(cfg, step),
                                   rtol=1e-6)


def test_clip_is_per_leaf():
    g = torch.tensor([3.0, 4.0])  # norm 5
    torch.testing.assert_close(TO.clip_by_norm_per_leaf(g, 10.0), g)
    torch.testing.assert_close(TO.clip_by_norm_per_leaf(g, 1.0),
                               torch.tensor([0.6, 0.8]))


@pytest.fixture(scope="module")
def both():
    """The tiny squeezeDet in both packages from the same weights, with a
    warmup, a decay after step 2 and a small clip norm, so every link of
    the chain acts within three updates."""
    cfg_kw = dict(learning_rate=0.01, decay_steps=2, lr_decay_factor=0.5,
                  lr_warmup_steps=2, max_grad_norm=0.05, momentum=0.9)
    jcfg = tiny_test_config().replace(**cfg_kw)
    jdet = jax_get_model("squeezeDet", jcfg)
    params, mask, _ = jdet.init(jax.random.key(0))
    det = st.get_model("squeezeDet", st.tiny_test_config().replace(**cfg_kw),
                       device="cpu")
    det.backbone.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, mask, det


def _grads(rng, params):
    """Seeded gradients for every leaf, some above the clip norm."""
    return jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32) * rng.choice([1e-3, 1.0])),
        params)


def test_three_updates_match_optax_chain(rng, both):
    """Three updates from the same gradients: params and momentum to
    rtol 1e-6 / atol 1e-9 (f32; the clip norm sums in another order);
    frozen conv1 never moves and has no state in the port."""
    jcfg, params, mask, det = both
    tx = JO.build_optimizer(jcfg, mask)
    state = tx.init(params)
    opt = TO.build_optimizer(det.cfg, det)
    assert "conv1.weight" not in opt.params and len(opt.params) == 62
    conv1 = det.backbone.conv1.weight.detach().clone()
    named = dict(det.backbone.named_parameters())
    for _ in range(3):
        grads = _grads(rng, params)
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for name, g in from_jax_params(jax.tree.map(np.asarray,
                                                    grads)).items():
            named[name].grad = g if named[name].requires_grad else None
        opt.update()
    assert opt.step == 3
    assert torch.equal(det.backbone.conv1.weight, conv1)
    want = from_jax_params(jax.tree.map(np.asarray, params))
    for name, p in det.backbone.state_dict().items():
        torch.testing.assert_close(p, want[name], rtol=1e-6, atol=1e-9)
    momentum = from_jax_opt_state(state, det.trainable_mask())["momentum"]
    for name, t in opt.trace.items():
        torch.testing.assert_close(t, momentum[name], rtol=1e-6, atol=1e-9)


def test_opt_state_bridge_round_trip_is_bit_identical(rng, both):
    jcfg, params, mask, det = both
    tx = JO.build_optimizer(jcfg, mask)
    like = tx.init(params)
    # a mid-training state: random trace at the trainable leaves, zeros
    # at the frozen ones, and a step count
    trace = jax.tree.map(
        lambda p, m: jnp.asarray(rng.randn(*p.shape).astype(np.float32))
        if m else jnp.zeros_like(p), params, mask)
    state = (like[0], like[1], like[2]._replace(trace=trace),
             like[3]._replace(count=jnp.asarray(17, jnp.int32)))
    opt = TO.build_optimizer(det.cfg, det)
    opt.load_state_dict(from_jax_opt_state(state, det.trainable_mask()))
    assert opt.step == 17
    back = to_jax_opt_state(opt.state_dict(), det.backbone.state_dict(), like)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    frozen = state[2].trace["conv1"]["kernel"]
    bad = (state[0], state[1], state[2]._replace(trace={
        **trace, "conv1": {"kernel": frozen + 1, "bias": trace["conv1"][
            "bias"]}}), state[3])
    with pytest.raises(ValueError):
        from_jax_opt_state(bad, det.trainable_mask())
