"""``span_kernels.<kind>.<phase>`` (kernels): the kernels that start
inside one of the program's phases per step: for each complete pair of
the phase's marker kernels in the traced window (``span_ms.pairs``), the
kernels (copies and fills not counted, markers excluded) that start
between the two, summed and divided by the window's steps.  None where
the window holds no pair."""

import bisect

from portbench.metrics.span_ms import pairs

MARKER = "squeezedet_span_"


def read(ctx, name):
    steps = ctx.window.get("steps", 0)
    found = pairs(ctx.trace, name.rsplit(".", 1)[-1])
    if not steps or not found:
        return None
    starts = sorted(s for n, s, _, _ in ctx.trace.kernels
                    if not n.startswith(MARKER))
    n = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
            for s, e in found)
    return n / steps
