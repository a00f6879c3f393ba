"""Per-unit readings of the program's own spans, counters and profiler
annotations, shared by the per-layer metrics that read them
(``bench/metrics/*.py``). Each returns None where the program records
nothing under the name (a version of it without that span or counter),
so a metric new to the benchmark is left out of such a run's line."""
from __future__ import annotations

from bench import tracemath


def ms_per_unit(ctx, names) -> float | None:
    """Milliseconds a unit of the traced stretch spent in the program's
    spans named ``names`` (nested or repeated spans counted once)."""
    if ctx.traced_units == 0 or not tracemath.span_intervals(ctx.spans,
                                                             names):
        return None
    return 1e3 * tracemath.span_seconds(ctx.spans, names) / ctx.traced_units


def count_per_unit(ctx, name: str) -> float | None:
    """A counter of the traced stretch, summed over its labels, per unit."""
    total = tracemath.counter_total(ctx.counters, name)
    if total is None or ctx.traced_units == 0:
        return None
    return total / ctx.traced_units


def annotations(ctx, name: str) -> list:
    """Disjoint (start, end) seconds of the profiled stretch's host
    annotations named ``name``: the program's spans, which annotate a
    profiler capture."""
    return tracemath.union(
        (ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6)
        for ev in ctx.device.host
        if ev.get("cat") == "user_annotation" and ev["name"] == name)


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two disjoint, sorted interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_ms(ctx, name: str) -> float | None:
    """Milliseconds a unit of the profiled stretch in which the device was
    idle inside the annotations named ``name``."""
    inside = annotations(ctx, name)
    if not inside or ctx.profiled_units == 0:
        return None
    busy = tracemath.union(ctx.device.intervals())
    idle = sum(e - s for s, e in inside) - overlap(inside, busy)
    return 1e3 * idle / ctx.profiled_units
