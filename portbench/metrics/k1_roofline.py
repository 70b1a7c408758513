"""``k1_roofline.<cell kind>`` (%): K1 (``conv1_pool1``, the fused conv1
+ pool1 kernel) against its bound at the cell's batch and image size
(``frozen.k1_bound``: the images read once and the pooled output
written once, or its operations at the bf16 peak), over K1's device
time per launch in the traced window."""

from portbench import frozen


def read(ctx, name):
    n = ctx.trace.count("conv1_pool1")
    if not n:
        return None
    per_call = ctx.trace.device_seconds("conv1_pool1") / n
    bound_ms, _ = frozen.k1_bound(ctx.mix["batch"], ctx.cfg["image_height"],
                                  ctx.cfg["image_width"])
    return 100.0 * bound_ms / 1e3 / per_call
