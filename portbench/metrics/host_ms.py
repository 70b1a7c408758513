"""``host_ms.<kind>.<part>`` (ms): the host's time inside the program's
range ``squeezedet.dispatch.<part>`` (``stage``: the inputs' copies into
the captured graph's buffers; ``replay``: the graph's launch) in the
traced window, summed and divided by the window's dispatches.  None
where the window holds no such range (a program without the spans)."""

PREFIX = "squeezedet.dispatch."


def ranges(trace, part):
    """[(start, end)] in ns of the host's ranges
    ``squeezedet.dispatch.<part>`` in the window."""
    name = PREFIX + part
    return [(s, e) for n, s, e in trace._host if n == name]


def read(ctx, name):
    dispatches = ctx.window.get("dispatches", 0)
    found = ranges(ctx.trace, name.rsplit(".", 1)[-1])
    if not dispatches or not found:
        return None
    return sum(e - s for s, e in found) / 1e6 / dispatches
