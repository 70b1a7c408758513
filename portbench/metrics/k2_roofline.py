"""``k2_roofline.<cell kind>`` (%): K2 (``filter_grad``, the weight
gradient kernel) against its bound over a train step: the sum of
``frozen.k2_bound`` over the convs whose weight gradient the program's
``"1x1"`` route gives K2 (stride-1 1x1 convs whose every input part has
a multiple of 128 channels, with a multiple of 16 positions and of 8
filters), each read once and written once, over K2's device time per
step in the traced window."""

from portbench import frozen
from portbench.reference.model import conv_shapes


def routed(cfg):
    """(kernel size, in channels, filters, height, width) of each conv
    whose weight gradient the "1x1" route gives K2.  A fire's squeeze
    takes the two halves of the previous fire's output as two parts."""
    parts, out = {}, []
    prev = None
    for layer in cfg["layers"]:
        if "fire" in layer:
            parts[layer["fire"]] = prev
            prev = (layer["e1x1"], layer["e3x3"])
        elif "conv" in layer:
            prev = (layer["filters"],)
    for name, c, o, k, s, h, w, _ in conv_shapes(cfg):
        fire, _, part = name.partition(".")
        ins = parts.get(fire) if part == "squeeze1x1" else (c,)
        if k == 1 and s == 1 and ins and all(p % 128 == 0 for p in ins) \
                and (h * w) % 16 == 0 and o % 8 == 0:
            out.append((k, c, o, h, w))
    return out


def read(ctx, name):
    n = ctx.trace.count("filter_grad")
    steps = ctx.window.get("steps", 0)
    if not n or not steps:
        return None
    per_step = ctx.trace.device_seconds("filter_grad") / steps
    b = ctx.mix["batch"]
    bound_ms = sum(frozen.k2_bound(b, k, c, o, h, w)[0]
                   for k, c, o, h, w in routed(ctx.cfg))
    return 100.0 * bound_ms / 1e3 / per_step
