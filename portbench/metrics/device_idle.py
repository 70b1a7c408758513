"""``device_idle.<cell kind>`` (%): the share of the traced window in
which no kernel, copy or fill ran on the device: 1 - (the union of
their intervals, averaged over the chips) / the window."""


def read(ctx, name):
    t = ctx.trace
    if not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
