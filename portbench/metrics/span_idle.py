"""``span_idle.<kind>.<part>`` (%): the share of the traced window in
which no kernel, copy or fill runs on the device while the host is
inside the program's range ``squeezedet.dispatch.<part>``: the union of
device intervals that ``device_idle`` takes, intersected with each such
range, its complement in the range summed over the ranges, over the
window.  None where the window holds no such range."""

from portbench.metrics.host_ms import ranges
from portbench.trace import _union


def idle_within(trace, spans):
    """The seconds of ``spans`` [(start, end)] ns in which no device
    interval of the window runs."""
    busy = _union((s, e) for _, s, e, _ in trace.device)
    idle = 0
    for s, e in spans:
        covered = sum(max(0, min(e, b1) - max(s, b0)) for b0, b1 in busy)
        idle += (e - s) - covered
    return idle / 1e9


def read(ctx, name):
    t = ctx.trace
    found = ranges(t, name.rsplit(".", 1)[-1])
    if not found or not t.device or t.window_s <= 0:
        return None
    return 100.0 * idle_within(t, found) / t.window_s
