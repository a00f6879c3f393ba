"""The device's idle share of the profiled stretch: one less the union of
its busy intervals over the stretch's wall time, in per cent."""
from bench import tracemath


def read(ctx):
    return tracemath.idle_share(ctx)
