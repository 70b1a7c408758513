"""``span_ms.<kind>.<phase>`` (ms): the device time of one of the
program's phases per step (a train step, or a scoring call), read off
the phase's marker kernels (``squeezedet_span_<phase>_begin`` and
``..._end``, which the program enqueues around the phase's work on its
stream, also inside its captured graph): for each complete pair in the
traced window, the begin marker's end to the end marker's start, summed
and divided by the window's steps.  A pair cut by the window's edge is
dropped.  None where the window holds no pair (a program without the
markers)."""

BEGIN, END = "squeezedet_span_{}_begin", "squeezedet_span_{}_end"


def pairs(trace, phase):
    """[(start, end)] in ns of the phase's complete marker pairs in the
    window: from its begin marker's end to its end marker's start."""
    begin, end = BEGIN.format(phase), END.format(phase)
    marks = sorted((s, e, n) for n, s, e, _ in trace.device
                   if n in (begin, end))
    out, opened = [], None
    for s, e, n in marks:
        if n == begin:
            opened = e
        elif opened is not None:
            out.append((opened, s))
            opened = None
    return out


def read(ctx, name):
    steps = ctx.window.get("steps", 0)
    found = pairs(ctx.trace, name.rsplit(".", 1)[-1])
    if not steps or not found:
        return None
    return sum(e - s for s, e in found) / 1e6 / steps
