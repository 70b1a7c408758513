"""Precisions the reference can compute in, on float32 arithmetic:
``fp8``, the control's, the step below bfloat16 that would tempt a
later change (a tensor is scaled by its own largest magnitude onto the
format's range, rounded to float8 and scaled back: e4m3 on the forward,
e5m2 for gradients, as float8 training recipes do); and ``bf16``, the
configuration's own, each conv's operands rounded to bfloat16, which
gives the size of the gaps that bfloat16 itself makes on a seed's
weights and inputs."""

from __future__ import annotations

import torch

_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_to(x, dtype):
    """``x`` rounded to ``dtype`` at a per-tensor scale, back in x's type."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = _MAX[dtype] / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_to(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, torch.float8_e5m2)


def fp8(x):
    """e4m3 on the way forward, e5m2 on the gradient's way back."""
    return _Fp8.apply(x)


def bf16(x):
    """``x`` rounded to bfloat16 (no gradient path: inference only)."""
    return x.to(torch.bfloat16).to(x.dtype)
