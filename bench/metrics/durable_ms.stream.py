"""Durability per stream step: the program's ``stream.wal`` spans (each
log record's copy to the host, write, flush and fsync) and
``stream.checkpoint`` spans. Read only where the program logs under
``stream.wal``: checkpoints alone are not the step's durable writes."""
from bench import spans, tracemath

NAMES = ("stream.wal", "stream.checkpoint")


def read(ctx):
    if not tracemath.span_intervals(ctx.spans, "stream.wal"):
        return None
    return spans.ms_per_unit(ctx, NAMES)
