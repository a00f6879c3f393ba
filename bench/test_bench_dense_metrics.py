"""The per-layer metrics that read the program's dense-cell counters,
``dense_share.resident`` and ``loose_evals.resident``: on hand-made
counters each reads its number per unit, and reads nothing, without
raising, from a program that records nothing under their names; a tiny
traced run of each cell that lists them reads them from the program (CPU)."""
import pytest

from bench import harness, tracemath


def _ctx(counters, traced_units):
    return harness.Readings(
        spans=[], counters=counters, traced_units=traced_units,
        device=tracemath.DeviceTrace({"traceEvents": []}),
        profiled_units=2, profiled_s=1.0,
        launches={"metrics": []}, work=None)


def _families(**values):
    """A snapshot of counters ``name=value``, each one series."""
    return {"metrics": [{"name": k, "kind": "counter",
                         "series": [{"labels": {}, "value": v}]}
                        for k, v in values.items()]}


@pytest.mark.parametrize("name, counters, want", [
    ("dense_share.resident", dict(dbscan_points_total=4000.0,
                                  dbscan_dense_points_total=3000.0), 75.0),
    ("dense_share.resident", dict(dbscan_points_total=4000.0,
                                  dbscan_dense_points_total=0.0), 0.0),
    ("loose_evals.resident", dict(traversal_loose_evals_total=900.0),
     900 / 4),
])
def test_dense_counters_per_unit(name, counters, want):
    read = harness.reader(name)
    assert read(_ctx(_families(**counters), traced_units=4)) \
        == pytest.approx(want)
    # a program without these counters: nothing to read, nothing raised
    assert read(_ctx(_families(dbscan_runs_total=4.0,
                               traversal_evals_total=10.0),
                     traced_units=4)) is None
    assert read(_ctx(_families(dbscan_points_total=0.0,
                               dbscan_dense_points_total=0.0,
                               traversal_loose_evals_total=0.0),
                     traced_units=0)) is None


@pytest.mark.parametrize("workload,expect", [
    ("porto.minpts_sweep", {"dense_share.resident", "loose_evals.resident"}),
    ("ngsim.minpts_sweep", {"hash_ms.resident", "host_syncs.resident",
                            "plan_host_ms.resident", "dense_share.resident",
                            "loose_evals.resident"}),
])
def test_a_traced_run_reads_the_dense_counters(workload, expect):
    # a tiny cell on the CPU: the counters and spans are the program's
    from bench.test_bench_loops import run, tiny
    res, limits, log = run(tiny(workload), trace=True)
    assert res["correct"], (limits, log)
    assert expect <= set(res["metrics"])
    assert all(res["metrics"][k]["value"] > 0 for k in expect)
