"""Sweeps per call, the fused first pass included: the program's
``dbscan_sweeps`` observations."""
from bench import tracemath


def read(ctx):
    total = tracemath.counter_total(ctx.counters, "dbscan_sweeps")
    if total is None or ctx.traced_units == 0:
        return None
    return total / ctx.traced_units
