"""Device ms a step in the program's point-encoder spans: `depth2pts`,
and PointNet++'s set-abstraction (`pn_sa`) and feature-propagation
(`pn_fp`) levels, all in the forward."""

from h100_bench import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, ("depth2pts", "pn_sa", "pn_fp"))
