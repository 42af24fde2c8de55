"""The share of the window in which no operation ran on the card."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
