"""``kernels_per_step.<cell kind>`` (kernels): device kernels launched
in the traced window (copies and fills not counted) per step."""


def read(ctx, name):
    steps = ctx.window.get("steps", 0)
    n = ctx.trace.count()
    if not steps or not n:
        return None
    return n / steps
