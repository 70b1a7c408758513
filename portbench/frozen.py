"""The yardstick's arithmetic: frozen copies, so that a later change to
the program cannot move what it is measured against.

Copied from commit c1706961c078b8aff91fbae120593a245d34c53b:

* :func:`cuda_ms`, :func:`graph_ms`, :func:`bound`, :func:`k1_bound` and
  :func:`k2_bound` from ``chip_smoke.py`` (``cuda_ms``, ``graph_ms``,
  ``bound``, ``k1_bound``, ``k2_bound``).  ``k1_bound`` called the port's
  ``fused_frontend.geometry``; the TF SAME output geometry is worked out
  here instead (:func:`same_out`).
* :func:`conv_flops`, the per-conv FLOP count of
  ``squeezedet_torch/models/layers.py`` ``NetTracer.conv``, summed over
  a configuration's convs in :func:`forward_flops`.
* :func:`k2_1x1_routed`, the ``"1x1"`` mode's rule of
  ``layers.filter_grad_eligible`` for a bfloat16 stride-1 SAME conv.

The peaks are the NVIDIA H100 SXM data sheet's dense rates at 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=10, replays=3):
    """Mean device time of ``fn`` in ms: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes, flops, peak):
    """(ms, what binds): the least time for moving ``nbytes`` and doing
    ``flops`` at the card's peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def same_out(size, k, s):
    """TF SAME along one dimension: (output size, pad before)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return out, total // 2


def valid_out(size, k, s):
    """TF VALID along one dimension: the output size."""
    return -(-(size - k + 1) // s)


def k1_geometry(h, w):
    """(Hc, Wc, Hp, Wp): the 3x3 stride-2 SAME conv's and then the 3x3
    stride-2 SAME pool's output sizes."""
    hc, wc = same_out(h, 3, 2)[0], same_out(w, 3, 2)[0]
    return hc, wc, same_out(hc, 3, 2)[0], same_out(wc, 3, 2)[0]


def k1_bound(b, h, w, f32=False):
    """K1 (bf16 on the tensor cores, or f32 on the CUDA cores): read the
    images once, write the pooled output once; 27 multiply-adds for each
    of the 64 channels of each conv output."""
    hc, wc, hp, wp = k1_geometry(h, w)
    size, peak = (4, F32_FLOPS) if f32 else (2, BF16_FLOPS)
    return bound(size * (b * h * w * 3 + b * hp * wp * 64),
                 2 * 27 * 64 * b * hc * wc, peak)


def k2_bound(b, kh, c, o, h, w, f32=False):
    """K2 (bf16 on the tensor cores, or f32 on the CUDA cores): read X and
    dY once, write dW (f32) once; a multiply-add for every (position,
    tap, c, o)."""
    m = b * h * w
    size, peak = (4, F32_FLOPS) if f32 else (2, BF16_FLOPS)
    return bound(size * m * (c + o) + 4 * kh * kh * c * o,
                 2 * m * c * o * kh * kh, peak)


def conv_flops(in_ch, filters, size, out_h, out_w, relu=True):
    """``NetTracer.conv``'s count for one conv: a multiply and an add for
    each tap, one add for the bias, and two for the ReLU."""
    flops = (1 + 2 * in_ch * size * size) * filters * out_h * out_w
    if relu:
        flops += 2 * filters * out_h * out_w
    return flops


def forward_flops(cfg):
    """FLOP of one image's forward through a configuration's convs (its
    reference network's ``conv_shapes``), in ``NetTracer``'s accounting
    (pools, dropout, batch norm, joins and the interpretation are not
    counted)."""
    from portbench.reference import network
    shapes = network(cfg).conv_shapes(cfg)
    return sum(conv_flops(c, o, k, h, w, relu)
               for _, c, o, k, _, h, w, relu in shapes)


def k2_1x1_routed(size, stride, parts, height, width, filters):
    """Whether the ``"1x1"`` route gives K2 the weight gradient of a
    bfloat16 stride-1 SAME conv taken by the program's plain conv: a 1x1
    kernel, every input part (``parts``, channels; the program takes a
    fire's two halves apart) a multiple of 128 channels, the positions
    of an image a multiple of 16, and the filters a multiple of 8."""
    return (size == 1 and stride == 1 and all(p % 128 == 0 for p in parts)
            and (height * width) % 16 == 0 and filters % 8 == 0)
