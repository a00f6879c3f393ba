"""The LBVH per call (topology, box fit, ropes): the program's
``build.tree`` spans."""
from bench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "build.tree")
