"""Label sweeps per call: the program's ``sweep`` spans (the fixpoint's
walks and the glue between them)."""
from bench import tracemath


def read(ctx):
    if ctx.traced_units == 0 or not tracemath.span_intervals(ctx.spans,
                                                             "sweep"):
        return None
    return 1e3 * tracemath.span_seconds(ctx.spans,
                                        "sweep") / ctx.traced_units
