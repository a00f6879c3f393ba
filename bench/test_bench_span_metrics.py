"""The per-layer metrics that read the program's own spans, counters and
profiler annotations, on hand-made readings (CPU): each reads its number
per unit, and each reads nothing, without raising, from a program that
records nothing under its names."""
import pytest

from bench import harness, spans, tracemath


def _ev(name, ts, dur, cat="repro"):
    return {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur}


def _counter(name, values):
    return {"metrics": [{"name": name, "kind": "counter",
                         "series": [{"labels": {"site": s}, "value": v}
                                    for s, v in values.items()]}]}


def _ctx(spans=(), counters=None, traced_units=2, trace_events=(),
         profiled_units=2):
    return harness.Readings(
        spans=list(spans), counters=counters or {"metrics": []},
        traced_units=traced_units,
        device=tracemath.DeviceTrace({"traceEvents": list(trace_events)}),
        profiled_units=profiled_units, profiled_s=1.0,
        launches={"metrics": []}, work=None)


# A traced stretch of two units, in microseconds: a plan with its hash and
# a build with its parts, a stream step's log records and a checkpoint.
SPANS = [
    _ev("plan", 0, 1000), _ev("plan.hash", 100, 300),
    _ev("build", 400, 500), _ev("build.grid", 400, 100),
    _ev("build.tree", 500, 250), _ev("build.pack", 750, 150),
    _ev("plan", 2000, 1000), _ev("plan.hash", 2000, 500),
    _ev("build", 2500, 400), _ev("build.tree", 2500, 150),
    _ev("build.pack", 2650, 250),
    _ev("stream.insert", 5000, 900), _ev("stream.wal", 5000, 200),
    _ev("stream.expire", 6000, 300), _ev("stream.wal", 6000, 50),
    _ev("stream.checkpoint", 7000, 750),
]


@pytest.mark.parametrize("name, want", [
    ("hash_ms.fresh", (300 + 500) / 2e3),
    ("hash_ms.resident", (300 + 500) / 2e3),
    ("grid_ms.fresh", 100 / 2e3),
    ("tree_ms.fresh", (250 + 150) / 2e3),
    ("pack_ms.fresh", (150 + 250) / 2e3),
    ("durable_ms.stream", (200 + 50 + 750) / 2e3),
])
def test_span_metrics_per_unit(name, want):
    read = harness.reader(name)
    assert read(_ctx(SPANS)) == pytest.approx(want)
    # a program without these spans: nothing to read, nothing raised (a
    # checkpoint alone is no reading of the log's cost)
    assert read(_ctx([_ev("plan", 0, 10), _ev("build", 0, 5),
                      _ev("stream.checkpoint", 0, 50)])) is None
    assert read(_ctx(SPANS, traced_units=0)) is None


@pytest.mark.parametrize("name", ["host_syncs.fresh", "host_syncs.resident",
                                  "host_syncs.stream"])
def test_host_syncs_per_unit(name):
    read = harness.reader(name)
    snap = _counter("host_syncs_total", {"fdbscan.sweep": 40.0,
                                         "unionfind.jump": 21.0,
                                         "dispatch.hash": 4.0})
    assert read(_ctx(counters=snap, traced_units=4)) == pytest.approx(65 / 4)
    assert read(_ctx(counters=_counter("dbscan_runs_total",
                                       {"x": 4.0}))) is None
    assert read(_ctx(counters=snap, traced_units=0)) is None


def _trace():
    """Two calls' profiled stretch (microseconds): ``sweep`` annotations at
    100-300 and 500-600, a ``plan`` annotation at 0-90, device work at
    50-150, 200-220, 250-260 and 550-700."""
    return [
        _ev("plan", 0, 90, "user_annotation"),
        _ev("sweep", 100, 200, "user_annotation"),
        _ev("sweep", 500, 100, "user_annotation"),
        _ev("sweep", 100, 200, "gpu_user_annotation"),   # device side: not
        _ev("aten::nonzero", 150, 40, "cpu_op"),         # an annotation
        _ev("walk_kernel<2>", 50, 100, "kernel"),
        _ev("walk_kernel<2>", 200, 20, "kernel"),
        _ev("Memcpy DtoH", 250, 10, "gpu_memcpy"),
        _ev("vectorized_elementwise", 550, 150, "kernel"),
    ]


def test_sweep_idle_reads_the_gaps_inside_sweeps_only():
    read = harness.reader("sweep_idle_ms.resident")
    ctx = _ctx(trace_events=_trace())
    # inside 100-300: busy 100-150, 200-220, 250-260 -> idle 120; inside
    # 500-600: busy 550-600 -> idle 50; the gap at 90-100 and after 700
    # lie outside every sweep
    assert read(ctx) == pytest.approx((120 + 50) / 2e3)
    got = spans.annotations(ctx, "sweep")
    assert [x for iv in got for x in iv] == pytest.approx(
        [100e-6, 300e-6, 500e-6, 600e-6])
    # no sweep annotations (a program whose spans do not annotate a
    # capture): nothing to read
    none = _ctx(trace_events=[e for e in _trace() if e["name"] != "sweep"
                              or e["cat"] != "user_annotation"])
    assert read(none) is None
    assert read(_ctx(trace_events=_trace(), profiled_units=0)) is None


def test_interval_overlap_on_hand_numbers():
    a = [(0, 2), (4, 6), (8, 9)]
    b = [(1, 5), (5.5, 8.5)]
    assert spans.overlap(a, b) == pytest.approx(1 + 1 + 0.5 + 0.5)
    assert spans.overlap([], b) == 0.0


@pytest.mark.parametrize("workload,expect", [
    ("hacc.fresh", {"hash_ms.fresh", "grid_ms.fresh", "tree_ms.fresh",
                    "host_syncs.fresh"}),
    ("porto.minpts_sweep", {"hash_ms.resident", "host_syncs.resident"}),
    ("porto.stream", {"host_syncs.stream", "durable_ms.stream"}),
])
def test_a_traced_run_reads_the_programs_own_spans(workload, expect):
    # a tiny cell on the CPU: the spans and counters are the program's;
    # the packed index and the device's idle time need the card
    from bench.test_bench_loops import run, tiny
    res, limits, log = run(tiny(workload), trace=True)
    assert res["correct"], (limits, log)
    assert expect <= set(res["metrics"])
    assert all(res["metrics"][k]["value"] > 0 for k in expect)
