"""The least time of the window's point work (h100_bench/points.py: K2-K6
and the backwards at the cell's shapes) over the device time of the
point kernels."""

from h100_bench import points


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    spent = t.seconds_where(points.is_point_kernel)
    if spent <= 0:
        return None
    least = points.step_s(ctx.run, ctx.rows) * ctx.steps
    return 100.0 * least / spent
