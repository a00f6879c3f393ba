"""The share of the clustered points that lie in dense cells of the plans'
indexes, in per cent: the program's ``dbscan_dense_points_total`` over its
``dbscan_points_total``, over the traced stretch (0 for a plain index)."""
from bench import tracemath


def read(ctx):
    points = tracemath.counter_total(ctx.counters, "dbscan_points_total")
    dense = tracemath.counter_total(ctx.counters, "dbscan_dense_points_total")
    if not points or dense is None:
        return None
    return 100.0 * dense / points
