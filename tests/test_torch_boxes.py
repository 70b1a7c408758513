"""Box primitives of the port against the JAX package (tolerance 1e-6)."""

import jax.numpy as jnp
import numpy as np
import torch

from squeezedet_torch.ops import boxes as tb
from squeezedet_tpu.ops import boxes as jb


def _boxes(rng, n):
    return np.stack([rng.uniform(0, 200, n), rng.uniform(0, 100, n),
                     rng.uniform(1, 80, n), rng.uniform(1, 60, n)],
                    axis=1).astype(np.float32)


def test_pairwise_iou_center_matches_jax(rng):
    a, b = _boxes(rng, 17), _boxes(rng, 11)
    b[3] = 0.0  # a padded zero box: only eps keeps 0/0 away
    for eps in (0.0, 1e-12):
        want = np.asarray(jb.pairwise_iou_center(jnp.asarray(a),
                                                 jnp.asarray(b), eps=eps))
        got = tb.pairwise_iou_center(torch.from_numpy(a),
                                     torch.from_numpy(b), eps=eps).numpy()
        assert got.shape == (17, 11)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pairwise_iou_center_batched_equals_per_image(rng):
    a = torch.from_numpy(np.stack([_boxes(rng, 9) for _ in range(3)]))
    got = tb.pairwise_iou_center(a, a)
    for i in range(3):
        torch.testing.assert_close(got[i], tb.pairwise_iou_center(a[i], a[i]),
                                   rtol=0, atol=0)


def test_safe_exp_matches_jax(rng):
    w = np.concatenate([rng.randn(200).astype(np.float32) * 3,
                        np.float32([-50.0, 0.0, 1.0, 1.0001, 80.0, 1e4])])
    want = np.asarray(jb.safe_exp(jnp.asarray(w), 1.0))
    got = tb.safe_exp(torch.from_numpy(w), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jb.safe_exp_np(w, 1.0), rtol=1e-6)


def test_safe_exp_zeroes_exp_input_in_linear_region():
    """Above the threshold the exp branch sees 0, so neither the value
    nor the gradient overflows."""
    w = torch.tensor([1e4, 100.0, -1.0], requires_grad=True)
    y = tb.safe_exp(w, 1.0)
    y.sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(w.grad).all()
    e = float(np.exp(1.0))
    torch.testing.assert_close(w.grad, torch.tensor([e, e, float(np.exp(-1))]))
