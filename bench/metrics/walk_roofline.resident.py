"""The walk kernel's share of its roofline: the least time the card could
take for the clusterings of the profiled stretch (``bench/roofline.py``,
counted from the inputs) over the walk kernel's device time in it."""
import sys

from bench import roofline, tracemath


def read(ctx):
    launches, seconds = tracemath.walk_launches(ctx)
    if launches is None or not ctx.work or any(w is None for w in ctx.work):
        return None
    t = [roofline.terms(*w) for w in ctx.work]
    bound = sum(x["bound_s"] for x in t)
    by = sorted({x["by"] for x in t})
    print(f"walk_roofline: bound {bound * 1e3:.6f} ms by {'/'.join(by)} "
          f"(operations {sum(x['ops'] for x in t):.6g}, bytes "
          f"{sum(x['bytes'] for x in t):.6g}) against {seconds * 1e3:.6f} ms "
          f"of walks in {launches} launches", file=sys.stderr)
    return roofline.share(bound, seconds)
