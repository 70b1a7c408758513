"""``mfu.<cell kind>`` (%): the whole step's share of the card's bf16
peak: the forward FLOP of an image (``frozen.forward_flops``, the
tracer's accounting of the configuration's convs), three times that
for a training image (forward, data and weight gradients; the matcher,
the augment and the optimizer are not counted), times the images the
traced window completed, over the window, over 989 TFLOP/s."""

from portbench import frozen


def read(ctx, name):
    images = ctx.window.get("images", 0)
    if not images or not ctx.trace.device:
        return None
    passes = 3 if ctx.mix["runner"] == "train" else 1
    flops = passes * frozen.forward_flops(ctx.cfg) * images
    return 100.0 * flops / ctx.trace.window_s / frozen.BF16_FLOPS
