"""Host syncs per stream step in the repair loop: the program's
``host_syncs_total``, summed over its sites. The stream counts only its
repair loop (site ``stream.repair``) and the clustering sites that loop
calls; the insert's, expiry's, query's and checkpoint's own host reads
are not counted."""
from bench import spans


def read(ctx):
    return spans.count_per_unit(ctx, "host_syncs_total")
