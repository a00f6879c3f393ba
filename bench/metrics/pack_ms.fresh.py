"""The walk kernel's packed index per call: the program's ``build.pack``
spans."""
from bench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "build.pack")
