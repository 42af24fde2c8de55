"""Model FLOPs done in the window (three forward passes a sample) over
the card's published bf16 dense peak."""

from h100_bench import roofline


def read(ctx):
    if ctx.window_s <= 0:
        return None
    done = 3 * ctx.forward_flops() * ctx.samples
    return 100.0 * done / ctx.window_s / roofline.BF16_OPS_S
