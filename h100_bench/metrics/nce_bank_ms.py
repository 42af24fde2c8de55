"""Device ms a step in the program's `nce` and `bank_update` spans: the
six-way NCE's forward against the banks, and the banks' update."""

from h100_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("nce", "bank_update"))
