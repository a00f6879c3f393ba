"""Host syncs per call: the program's ``host_syncs_total`` (reads of
device values and operations the host waits on), summed over its sites."""
from bench import spans


def read(ctx):
    return spans.count_per_unit(ctx, "host_syncs_total")
