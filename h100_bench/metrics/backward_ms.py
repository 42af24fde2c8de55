"""Device ms a step in the program's `backward` spans: the loss's
backward, the NCE's own with its bank gathers included."""

from h100_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("backward",))
