"""The grid per call (the segments or the eps-grid, and the Morton sort):
the program's ``build.grid`` spans."""
from bench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "build.grid")
