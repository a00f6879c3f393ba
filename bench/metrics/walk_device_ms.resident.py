"""Device time of the walk kernel per call, from the profiled stretch.
Read only when the device trace holds as many walk launches as the
program counted (``pallas_kernel_launches_total``)."""
from bench import tracemath


def read(ctx):
    launches, seconds = tracemath.walk_launches(ctx)
    if launches is None:
        return None
    return 1e3 * seconds / ctx.profiled_units
