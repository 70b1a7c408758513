"""Optimizer: SGD + momentum with staircase-exponential LR decay and
per-leaf gradient-norm clipping (counterpart of
``squeezedet_tpu/optim.py``).

The JAX package chains optax transforms: frozen leaves masked to zero,
``clip_by_norm`` leaf by leaf, ``optax.trace(decay=momentum,
nesterov=False)`` (trace = g + momentum * trace), then ``-lr(count)``,
where the first update uses ``lr(0)``.  :class:`Momentum` applies the
same chain to the parameters that train (``requires_grad``); frozen
leaves hold no state here (their optax trace stays zero), and the weight
bridge (``weights.from_jax_opt_state`` / ``to_jax_opt_state``) maps the
two states onto each other.

The schedule is computed in float32, as the JAX schedule computes it.
A step captured in a CUDA graph cannot read a host float that changes
between replays: :meth:`Momentum.update` then takes the step's negated
rate as a device tensor, staged for a dispatch's steps by
:meth:`Momentum.dispatch_rates` from the same schedule.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def staircase_exponential_decay(lr0: float, decay_steps: int,
                                decay_factor: float,
                                warmup_steps: int = 0) -> Callable:
    """lr0 * factor^floor(step / decay_steps), times a linear warmup
    ramp min(1, (step + 1) / warmup_steps) when warmup_steps > 0; float32."""
    f32 = np.float32

    def schedule(step) -> np.float32:
        step = f32(step)
        lr = f32(lr0) * f32(decay_factor) ** np.floor(step / f32(decay_steps))
        if warmup_steps > 0:
            lr = lr * np.minimum(f32(1.0), (step + f32(1.0)) /
                                 f32(warmup_steps))
        return f32(lr)
    return schedule


def clip_by_norm_per_leaf(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """tf.clip_by_norm of one leaf: g * max_norm / max(||g||, max_norm)."""
    norm = torch.sqrt(torch.sum(torch.square(g)))
    return g * (max_norm / torch.clamp(norm, min=max_norm))


class Momentum:
    """Clip -> momentum -> -lr(step) over the named parameters that
    train.  :meth:`update` reads each parameter's ``.grad`` and updates
    the parameter and its momentum buffer in place."""

    def __init__(self, named_params, *, momentum: float, max_grad_norm: float,
                 schedule: Callable):
        self.params: Dict[str, torch.Tensor] = {
            name: p for name, p in named_params if p.requires_grad}
        self.momentum = momentum
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule
        self.trace = {name: torch.zeros_like(p)
                      for name, p in self.params.items()}
        self.step = 0

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def dispatch_rates(self, k: int) -> np.ndarray:
        """The schedule's rates of the ``k`` steps from :attr:`step`, as a
        float32 [k] array."""
        return np.array([self.schedule(self.step + i) for i in range(k)],
                        np.float32)

    @torch.no_grad()
    def update(self, neg_lr=None) -> None:
        """One step at ``-schedule(step)``, or at ``neg_lr``, the negated
        rate as a 0-d f32 tensor on the parameters' device (a captured
        step's, which the host fills before each replay)."""
        if neg_lr is None:
            neg_lr = -float(self.schedule(self.step))
        for name, p in self.params.items():
            if p.grad is None:
                raise RuntimeError("no gradient for {}".format(name))
            g = clip_by_norm_per_leaf(p.grad, self.max_grad_norm)
            t = self.trace[name]
            t.mul_(self.momentum).add_(g)
            p.add_(t * neg_lr)
        self.step += 1

    def state_dict(self) -> dict:
        return {"step": self.step,
                "momentum": {n: t.clone() for n, t in self.trace.items()}}

    def load_state_dict(self, state: dict) -> None:
        if set(state["momentum"]) != set(self.trace):
            raise ValueError("momentum names {} do not match the trainable "
                             "parameters {}".format(sorted(state["momentum"]),
                                                    sorted(self.trace)))
        for name, t in state["momentum"].items():
            self.trace[name].copy_(t)
        self.step = int(state["step"])


def build_optimizer(cfg, det) -> Momentum:
    """The JAX package's chain over ``det.backbone``'s trainable
    parameters (named as its state_dict)."""
    schedule = staircase_exponential_decay(
        cfg.learning_rate, cfg.decay_steps, cfg.lr_decay_factor,
        warmup_steps=cfg.lr_warmup_steps)
    return Momentum(det.backbone.named_parameters(), momentum=cfg.momentum,
                    max_grad_norm=cfg.max_grad_norm, schedule=schedule)


def learning_rate_at(cfg, step: int) -> float:
    lr = float(cfg.learning_rate
               * cfg.lr_decay_factor ** (step // cfg.decay_steps))
    if cfg.lr_warmup_steps > 0:
        lr *= min(1.0, (step + 1.0) / cfg.lr_warmup_steps)
    return lr
