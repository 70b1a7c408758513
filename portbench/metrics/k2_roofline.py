"""``k2_roofline.<cell kind>`` (%): K2 (``filter_grad``, the weight
gradient kernel) against its bound over a train step: the sum of
``frozen.k2_bound`` over the convs whose weight gradient the program's
``"1x1"`` route gives K2 (the reference network's ``k2_routed``, by
``frozen.k2_1x1_routed``), each read once and written once, over K2's
device time per step in the traced window."""

from portbench import frozen
from portbench.reference import network


def read(ctx, name):
    n = ctx.trace.count("filter_grad")
    steps = ctx.window.get("steps", 0)
    b = ctx.mix["batch"]
    bound_ms = sum(frozen.k2_bound(b, k, c, o, h, w)[0]
                   for k, c, o, h, w in network(ctx.cfg).k2_routed(ctx.cfg))
    if not n or not steps or not bound_ms:
        return None
    per_step = ctx.trace.device_seconds("filter_grad") / steps
    return 100.0 * bound_ms / 1e3 / per_step
