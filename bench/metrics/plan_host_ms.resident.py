"""Host time of dispatch's ``plan`` per call, its ``build`` children left
out: input checks, the content hash, the decision, the LRU, and whatever
else ``plan`` runs outside a ``build`` span."""
from bench import tracemath


def read(ctx):
    if ctx.traced_units == 0 or not tracemath.span_intervals(ctx.spans,
                                                             "plan"):
        return None
    return 1e3 * tracemath.self_seconds(ctx.spans, "plan",
                                        "build") / ctx.traced_units
