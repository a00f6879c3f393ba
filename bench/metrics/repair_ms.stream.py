"""Label repair per stream step: the program's ``stream.repair`` spans."""
from bench import tracemath


def read(ctx):
    if ctx.traced_units == 0 or not tracemath.span_intervals(
            ctx.spans, "stream.repair"):
        return None
    return 1e3 * tracemath.span_seconds(ctx.spans,
                                        "stream.repair") / ctx.traced_units
