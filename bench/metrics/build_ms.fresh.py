"""Index build per call: the program's ``build`` spans."""
from bench import tracemath


def read(ctx):
    if ctx.traced_units == 0 or not tracemath.span_intervals(ctx.spans,
                                                             "build"):
        return None
    return 1e3 * tracemath.span_seconds(ctx.spans,
                                        "build") / ctx.traced_units
