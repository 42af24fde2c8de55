"""Device ms a step in the port's point kernels (h100_bench/points.py):
FPS, ball query, three-NN, K5's and K6's forwards, K56a and K56b."""

from h100_bench import points


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.seconds_where(points.is_point_kernel)
    return s * 1e3 / ctx.steps if s > 0 else None
