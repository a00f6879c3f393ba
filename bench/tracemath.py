"""Reductions from spans, counters and a profiler trace to numbers.

Spans are the program's (``repro_torch.obs.trace`` events: ``name``,
``ts`` and ``dur`` in microseconds); the device trace is the Chrome trace
that ``torch.profiler`` exports. Plain Python and ``json``: nothing here
touches a device.
"""
from __future__ import annotations

import json

# Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host-side categories that say what the host was doing.
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def union(intervals) -> list:
    """Merge ``(start, end)`` intervals into disjoint, sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals) -> float:
    """Total length of the union of ``intervals``."""
    return sum(e - s for s, e in union(intervals))


def span_intervals(events, names) -> list:
    """``(start, end)`` in seconds of the complete events named in
    ``names``."""
    names = {names} if isinstance(names, str) else set(names)
    return [(ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6)
            for ev in events if ev.get("ph") == "X" and ev["name"] in names]


def span_seconds(events, names) -> float:
    """Seconds covered by spans named in ``names`` (nested or repeated
    spans counted once)."""
    return covered(span_intervals(events, names))


def self_seconds(events, name, children) -> float:
    """Seconds covered by ``name`` spans and not by ``children`` spans."""
    outer = union(span_intervals(events, name))
    inner = union(span_intervals(events, children))
    total = sum(e - s for s, e in outer)
    cut = 0.0
    for s, e in outer:
        for a, b in inner:
            lo, hi = max(s, a), min(e, b)
            if hi > lo:
                cut += hi - lo
    return total - cut


def counter_total(snapshot: dict, name: str) -> float | None:
    """Sum over the labels of a counter family (its values) or of a
    histogram family (its observations' sums) in a registry snapshot
    (``repro.obs/v1``), or None when the family is absent."""
    fams = [f for f in snapshot.get("metrics", []) if f.get("name") == name]
    if not fams:
        return None
    total = 0.0
    for s in fams[0].get("series", []):
        total += s["sum"] if "sum" in s else s.get("value", 0.0)
    return total


class DeviceTrace:
    """The device side of one profiled stretch, from its Chrome trace."""

    def __init__(self, doc: dict):
        evs = doc.get("traceEvents", [])
        self.device = [ev for ev in evs if ev.get("ph") == "X"
                       and ev.get("cat") in DEVICE_CATS]
        self.host = [ev for ev in evs if ev.get("ph") == "X"
                     and ev.get("cat") in HOST_CATS]

    @classmethod
    def load(cls, path: str) -> "DeviceTrace":
        with open(path) as f:
            return cls(json.load(f))

    def intervals(self, match=None) -> list:
        return [(ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6)
                for ev in self.device
                if match is None or match in ev["name"]]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return covered(self.intervals())

    def kernel_seconds(self, match: str) -> tuple:
        """(launches, seconds) of device operations whose name contains
        ``match``."""
        iv = self.intervals(match)
        return len(iv), sum(e - s for s, e in iv)

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time, by name."""
        by: dict = {}
        for ev in self.device:
            by[ev["name"]] = by.get(ev["name"], 0.0) + ev["dur"] * 1e-6
        return sorted(([n[:120], s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, t0: float, t1: float, k: int = 10) -> list:
        """Idle stretches of the device inside ``[t0, t1]`` (seconds on
        the trace's clock), summed by what the host was doing in the
        middle of each: the innermost host operation that spans the
        stretch's midpoint. The ``k`` largest sums."""
        busy = [(max(s, t0), min(e, t1)) for s, e in union(self.intervals())
                if e > t0 and s < t1]
        gaps, cur = [], t0
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if t1 > cur:
            gaps.append((cur, t1))
        host = sorted(((ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6,
                        ev["name"]) for ev in self.host))
        by: dict = {}
        live, nxt = [], 0            # a sweep over the gaps in time order
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            while nxt < len(host) and host[nxt][0] <= mid:
                live.append(host[nxt])
                nxt += 1
            live = [h for h in live if h[1] >= g0]
            inner = [h for h in live if h[0] <= mid <= h[1]]
            name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                    else "host Python, no torch operation")[:120]
            by[name] = by.get(name, 0.0) + (g1 - g0)
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def extent(self) -> tuple:
        """(first start, last end) over device and host events."""
        evs = self.device + self.host
        if not evs:
            return 0.0, 0.0
        return (min(ev["ts"] for ev in evs) * 1e-6,
                max(ev["ts"] + ev["dur"] for ev in evs) * 1e-6)


# The walk kernel's name in the device trace (``csrc/walk.cu``).
WALK_KERNEL = "walk_kernel"


def walk_launches(ctx) -> tuple:
    """(launches, seconds) of the walk kernel in the profiled stretch of
    ``ctx`` (``harness.Readings``), or ``(None, None)`` unless the trace
    holds every launch the program counted."""
    n, seconds = ctx.device.kernel_seconds(WALK_KERNEL)
    counted = counter_total(ctx.launches, "pallas_kernel_launches_total")
    if n == 0 or counted is None or n != int(counted):
        return None, None
    return n, seconds


def idle_share(ctx) -> float | None:
    """Per cent of the profiled stretch in which the device was idle, or
    None when the trace shows no device work."""
    busy = ctx.device.busy_s()
    if busy <= 0 or ctx.profiled_s <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.profiled_s)
