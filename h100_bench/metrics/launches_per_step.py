"""Kernels launched a step (copies and fills the driver runs left out)."""

from h100_bench import devtrace


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    n = t.count_where(devtrace.is_launch)
    return n / ctx.steps if n else None
