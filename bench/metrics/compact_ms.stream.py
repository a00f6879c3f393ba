"""Compaction per stream step: the program's ``stream.compact`` and
``stream.merge`` spans."""
from bench import tracemath

NAMES = ("stream.compact", "stream.merge")


def read(ctx):
    if ctx.traced_units == 0 or not tracemath.span_intervals(ctx.spans,
                                                             NAMES):
        return None
    return 1e3 * tracemath.span_seconds(ctx.spans,
                                        NAMES) / ctx.traced_units
