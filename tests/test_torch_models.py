"""Layers, the squeezeDet backbone and the weight bridge of the port
against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch.models import layers as TL
from squeezedet_torch.weights import from_jax_params, to_jax_params
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.models import get_model as jax_get_model
from squeezedet_tpu.models import layers as JL


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX tiny-config params with random biases and an N(0, 1) head, so
    every bias is exercised and the preds are O(1) rather than ~1e-4."""
    det = jax_get_model("squeezeDet", tiny_test_config())
    params, _, _ = det.init(jax.random.key(0))
    rng = np.random.RandomState(1)
    tree = jax.tree.map(np.asarray, params)

    def perturb(layer):
        if "kernel" not in layer:
            return {k: perturb(v) for k, v in layer.items()}
        return {"kernel": layer["kernel"],
                "bias": (rng.randn(*layer["bias"].shape) * 0.1)
                .astype(np.float32)}

    tree = perturb(tree)
    tree["conv12"]["kernel"] = rng.randn(3, 3, 768, 72).astype(np.float32)
    return det, jax.tree.map(jnp.asarray, tree), tree


def _conv_pair(rng, cin, cout, k):
    kern = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    jp = {"kernel": jnp.asarray(kern), "bias": jnp.asarray(bias)}
    tp = TL.Conv(torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                 torch.from_numpy(bias))
    return jp, tp


def test_param_count_full_size():
    det = st.get_model("squeezeDet", st.kitti_squeezedet_config(),
                       device="cpu")
    assert det.backbone.tracer.total_params() == 2082120
    assert sum(p.numel() for p in det.parameters()) == 2082120
    sizes = dict(det.backbone.tracer.model_size_counter)
    assert sizes["conv1"] == (1 + 9 * 3) * 64
    assert sizes["conv12"] == (1 + 9 * 768) * 72
    assert not det.backbone.conv1.weight.requires_grad  # frozen, as in JAX


def test_init_is_seeded_by_generator():
    cfg = st.tiny_test_config()
    a = st.get_model("squeezeDet", cfg, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    b = st.get_model("squeezeDet", cfg, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    # xavier limits and the 1e-4 truncated-normal head
    w = a.backbone.conv1.weight
    assert w.abs().max() <= np.sqrt(6.0 / (9 * (3 + 64)))
    assert a.backbone.conv12.weight.abs().max() <= 2e-4


def test_bridge_round_trip_is_bit_identical(jax_tiny):
    _, _, tree = jax_tiny
    state = from_jax_params(tree)
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu")
    det.backbone.load_state_dict(state)  # strict: every name maps
    back = to_jax_params(det.backbone.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    assert tuple(state["fire2.expand3x3.weight"].shape) == (64, 16, 3, 3)


@pytest.mark.parametrize("stride,k,padding,size", [
    (1, 3, "SAME", (12, 10)), (2, 3, "SAME", (12, 10)),
    (2, 3, "SAME", (11, 9)), (1, 1, "SAME", (7, 7)),
    (2, 3, "VALID", (11, 10))])
def test_conv2d_matches_jax(rng, stride, k, padding, size):
    """Tolerance 1e-5 (f32, different summation order)."""
    jp, tp = _conv_pair(rng, 5, 8, k)
    x = rng.randn(2, *size, 5).astype(np.float32)
    for relu in (True, False):
        want = np.asarray(JL.conv2d(jp, jnp.asarray(x), stride, padding,
                                    relu=relu))
        got = TL.conv2d(tp, torch.from_numpy(x), stride, padding,
                        relu=relu).detach().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,padding,k,s", [
    ((12, 10), "SAME", 3, 2), ((11, 9), "SAME", 3, 2),
    ((12, 9), "SAME", 3, 2), ((6, 6), "SAME", 3, 2), ((1, 2), "SAME", 3, 2),
    ((12, 10), "VALID", 3, 2), ((11, 9), "VALID", 3, 2),
    ((7, 6), "SAME", 2, 1)])
def test_max_pool_matches_jax(rng, size, padding, k, s):
    """Max is exact: tolerance 0.  3x3 s2 SAME takes torch's own padding
    (symmetric or ceil_mode); 2x2 s1 SAME pads (0, 1) with -inf."""
    x = rng.randn(2, *size, 4).astype(np.float32)
    want = np.asarray(JL.max_pool(jnp.asarray(x), k, s, padding))
    got = TL.max_pool(torch.from_numpy(x), k, s, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_fire_pair_matches_jax(rng, jax_tiny):
    """Single-tensor and pair inputs, with and without the pool, to 1e-5."""
    _, params, tree = jax_tiny
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cpu")
    det.backbone.load_state_dict(from_jax_params(tree))
    x = np.abs(rng.randn(2, 12, 10, 64)).astype(np.float32)
    xa = np.abs(rng.randn(2, 12, 10, 64)).astype(np.float32)
    xb = np.abs(rng.randn(2, 12, 10, 64)).astype(np.float32)
    for name, inp, pool in [("fire2", x, None), ("fire3", (xa, xb), (3, 2))]:
        jin = tuple(map(jnp.asarray, inp)) if isinstance(inp, tuple) \
            else jnp.asarray(inp)
        tin = tuple(map(torch.from_numpy, inp)) if isinstance(inp, tuple) \
            else torch.from_numpy(inp)
        want = JL.fire_pair(params[name], jin, pool=pool)
        with torch.no_grad():
            got = TL.fire_pair(getattr(det.backbone, name), tin, pool=pool)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_preds_match_jax(rng, jax_tiny, dtype):
    """Backbone + head preds at the tiny config: f32 to rtol 1e-4 /
    atol 1e-5; bf16 (rounding at different places in the two frameworks)
    to 5e-2 of the preds' largest magnitude."""
    jdet, params, tree = jax_tiny
    cfg = st.tiny_test_config().replace(compute_dtype=dtype)
    jdet = jax_get_model("squeezeDet", jdet.cfg.replace(compute_dtype=dtype))
    det = st.get_model("squeezeDet", cfg, device="cpu")
    det.backbone.load_state_dict(from_jax_params(tree))
    x = (rng.rand(2, 96, 96, 3) * 255 - 120).astype(np.float32)
    want = np.asarray(jdet.forward(params, jnp.asarray(x)))
    with torch.no_grad():
        got = det(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 6, 6, 72)
    assert got.dtype == np.float32 and np.abs(want).std() > 0.05
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * scale)
