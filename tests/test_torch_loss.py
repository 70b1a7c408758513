"""detection_loss of the port against the JAX package on the CPU: the
three terms, the mean IoU and the gradient into the preds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from squeezedet_torch.models import skeleton as TS
from squeezedet_tpu.config import tiny_test_config
from squeezedet_tpu.models import skeleton as JS

CFG = tiny_test_config()


def _coefs(cfg):
    return dict(num_anchors=cfg.anchors, loss_coef_class=cfg.loss_coef_class,
                loss_coef_conf_pos=cfg.loss_coef_conf_pos,
                loss_coef_conf_neg=cfg.loss_coef_conf_neg,
                loss_coef_bbox=cfg.loss_coef_bbox, epsilon=cfg.epsilon)


def _inputs(rng, num_objects, scale=0.1):
    b, a, c = CFG.batch_size, CFG.anchors, CFG.classes
    preds = (rng.randn(b, CFG.grid_h, CFG.grid_w, CFG.head_channels)
             * scale).astype(np.float32)
    mask = np.zeros((b, a), np.float32)
    labels = np.zeros((b, a, c), np.float32)
    deltas = np.zeros((b, a, 4), np.float32)
    boxes = np.zeros((b, a, 4), np.float32)
    for i in range(b):
        for j in rng.choice(a, num_objects, replace=False):
            mask[i, j] = 1.0
            labels[i, j, rng.randint(c)] = 1.0
            deltas[i, j] = rng.randn(4) * 0.1
            boxes[i, j] = [40 + rng.rand() * 10, 40 + rng.rand() * 10,
                           20 + rng.rand() * 10, 20 + rng.rand() * 10]
    return preds, (mask, deltas, boxes, labels)


def _interp_kw(cfg):
    return dict(num_classes=cfg.classes, anchor_per_grid=cfg.anchor_per_grid,
                image_width=cfg.image_width, image_height=cfg.image_height,
                exp_thresh=cfg.exp_thresh)


def _jax_loss(preds, targets, probs_only, wd):
    anchors = jnp.asarray(CFG.anchor_box, jnp.float32)

    def f(p):
        interp = JS.interpret(p, anchors, **_interp_kw(CFG))
        if probs_only:
            interp = interp._replace(pred_class_logits=None)
        lb = JS.detection_loss(interp, JS.Targets(*map(jnp.asarray, targets)),
                               weight_decay_term=wd, **_coefs(CFG))
        return lb.total, lb
    grad, lb = jax.grad(f, has_aux=True)(jnp.asarray(preds))
    return [float(v) for v in lb], np.asarray(grad)


def _port_loss(preds, targets, probs_only, wd):
    anchors = torch.tensor(CFG.anchor_box, dtype=torch.float32)
    p = torch.from_numpy(preds).requires_grad_()
    interp = TS.interpret(p, anchors, **_interp_kw(CFG))
    if probs_only:
        interp = interp._replace(pred_class_logits=None)
    lb = TS.detection_loss(
        interp, TS.Targets(*map(torch.from_numpy, targets)),
        weight_decay_term=wd, **_coefs(CFG))
    lb.total.backward()
    return [float(v.detach()) for v in lb], p.grad.numpy()


@pytest.mark.parametrize("case", ["random", "no_gt", "probs_only",
                                  "saturated", "saturated_probs_only"])
def test_detection_loss_matches_jax(rng, case):
    """Loss terms to rtol 1e-5 and the gradient into the preds to
    rtol 1e-4 / atol 1e-6 of its largest magnitude (f32, sums in other
    orders).  ``no_gt``: every image has num_gt=0, so the class and box
    terms are zero and the conf term is all negatives (max(sum(mask), 1)
    guard).  ``saturated``: logits of +-60, where the log-space class loss
    keeps its gradient bounded and the probs-only branch keeps the
    reference formula."""
    probs_only = case.endswith("probs_only")
    num_objects = 0 if case == "no_gt" else 3
    scale = 30.0 if case.startswith("saturated") else 0.1
    preds, targets = _inputs(rng, num_objects, scale)
    if case.startswith("saturated"):
        ncp = CFG.anchor_per_grid * CFG.classes
        preds[..., :ncp] = np.sign(preds[..., :ncp]) * 60.0
    want, want_g = _jax_loss(preds, targets, probs_only, 0.25)
    got, got_g = _port_loss(preds, targets, probs_only, 0.25)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.isfinite(got_g).all()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4,
                               atol=1e-6 * np.abs(want_g).max())
    if case == "no_gt":
        assert got[1] == 0.0 and got[3] == 0.0 and got[2] > 0.0


def test_conf_target_iou_is_detached(rng):
    """The conf term's IoU target is detached, so the conf term sends no
    gradient into the box deltas through the decoded boxes."""
    preds, targets = _inputs(rng, 3)
    anchors = torch.tensor(CFG.anchor_box, dtype=torch.float32)
    p = torch.from_numpy(preds).requires_grad_()
    interp = TS.interpret(p, anchors, **_interp_kw(CFG))
    lb = TS.detection_loss(interp, TS.Targets(*map(torch.from_numpy,
                                                   targets)), **_coefs(CFG))
    d_conf = torch.autograd.grad(lb.conf_loss, interp.pred_box_delta,
                                 retain_graph=True, allow_unused=True)[0]
    assert d_conf is None or not d_conf.any()
