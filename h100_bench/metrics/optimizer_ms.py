"""Device ms a step in the program's `optimizer` spans: the missing
gradients filled, their sum over the ranks (`grad_sync`) and SGD's
step."""

from h100_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("optimizer",))
