"""Device idle time per call inside the label sweeps: the profiled
stretch's ``sweep`` annotations (the program's spans) less the device's
busy intervals within them: the glue and host reads between walks."""
from bench import spans


def read(ctx):
    return spans.idle_inside_ms(ctx, "sweep")
