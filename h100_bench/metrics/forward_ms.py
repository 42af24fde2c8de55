"""Device ms a step in the program's `forward` spans: the input
normalisation and the model's forward."""

from h100_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("forward",))
