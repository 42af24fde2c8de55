"""Device ms a step in batch norm and in copies, casts and fills."""

from h100_bench import devtrace


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.seconds_where(
        lambda n: devtrace.kernel_class(n) in devtrace.BN_AND_CASTS)
    return s * 1e3 / ctx.steps if s > 0 else None
