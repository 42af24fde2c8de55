"""The least time of the window's fused ConvBN work (K1 and K1b at every
1x1 ConvBN site of the cell's shapes) over the device time of the K1 and
K1b kernels."""

from h100_bench import roofline


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    spent = t.seconds_where(lambda n: "mm_bn_" in n or "k1b_" in n)
    if spent <= 0:
        return None
    run = ctx.run
    encoders = 2 if run["arch"] == "HRNet" else 1
    least = roofline.convbn_step_s(run["width"], run["crop_size"],
                                   ctx.rows, encoders) * ctx.steps
    return 100.0 * least / spent
