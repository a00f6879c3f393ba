"""The content hash per call: the program's ``plan.hash`` spans (the copy
of the points to host memory and its SHA-1)."""
from bench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "plan.hash")
