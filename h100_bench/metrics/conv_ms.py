"""Device ms a step in convolution kernels."""

from h100_bench import devtrace


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.seconds_where(lambda n: devtrace.kernel_class(n) == devtrace.CONV)
    return s * 1e3 / ctx.steps if s > 0 else None
