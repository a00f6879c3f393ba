"""The port's observability layer (``repro_torch.obs``): registry
semantics, sketch accuracy and memory bounds, trace export and sync
marking, the disabled fast path, schema stability, artifact validation —
and parity with the reference package's layer: the same clustering run
under each package's collectors gives the same counters and spans, and
each package's validators accept the other's files."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

import repro  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.obs import metrics as jmetrics, trace as jtrace  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.obs import validate as obs_validate  # noqa: E402

from conftest import separated_points  # noqa: E402


# --------------------------------------------------------------------- #
# registry semantics                                                    #
# --------------------------------------------------------------------- #

def test_counter_monotone_and_labels():
    reg = metrics.Registry()
    fam = reg.counter("requests_total", labels=("kind",))
    fam.labels(kind="insert").inc()
    fam.labels(kind="insert").inc(2.5)
    fam.labels(kind="query").inc()
    assert fam.labels(kind="insert").value == 3.5
    assert fam.labels(kind="query").value == 1.0
    with pytest.raises(ValueError):
        fam.labels(kind="insert").inc(-1)
    # typo'd label names raise, not fork a parallel series
    with pytest.raises(ValueError):
        fam.labels(kinds="insert")


def test_family_conflicts_raise():
    reg = metrics.Registry()
    reg.counter("x", labels=("a",))
    with pytest.raises(ValueError):
        reg.gauge("x", labels=("a",))          # kind conflict
    with pytest.raises(ValueError):
        reg.counter("x", labels=("b",))        # label-set conflict
    assert reg.get("absent") is None
    reg.counter("c", labels=("k",)).labels(k="v").inc()
    assert reg.get("c", k="v").value == 1.0
    assert reg.get("c", k="other") is None     # reading never creates


# --------------------------------------------------------------------- #
# histogram sketch: accuracy, memory bound, cap, zero bucket            #
# --------------------------------------------------------------------- #

def test_histogram_quantiles_within_relative_accuracy():
    vals = np.exp(np.random.default_rng(0).normal(-7.0, 1.5, size=20_000))
    h = metrics.Histogram()
    for v in vals:
        h.observe(float(v))
    for q in (0.5, 0.95, 0.99):
        exact = float(np.quantile(vals, q))
        assert abs(h.quantile(q) - exact) / exact \
            <= 3 * metrics.REL_ACCURACY, q
    assert h.count == len(vals)
    assert math.isclose(h.sum, float(vals.sum()), rel_tol=1e-9)
    assert h.min == float(vals.min()) and h.max == float(vals.max())


def test_histogram_memory_flat_and_capped():
    h = metrics.Histogram()
    lo, hi = 1e-4, 1e-1
    range_buckets = math.ceil(math.log(hi / lo) / h._log_gamma) + 1
    rng = np.random.default_rng(1)
    for v in rng.uniform(lo, hi, size=60_000):
        h.observe(float(v))
    assert h.bucket_count() <= range_buckets < 400
    # one observation per bucket across a huge range: the lowest collapse
    capped = metrics.Histogram()
    step = capped._log_gamma * 1.01
    for i in range(metrics.MAX_BUCKETS + 200):
        capped.observe(math.exp((i - 100) * step))
    assert capped.bucket_count() <= metrics.MAX_BUCKETS
    assert capped.count == metrics.MAX_BUCKETS + 200


def test_histogram_zero_bucket_and_empty():
    h = metrics.Histogram()
    assert math.isnan(h.quantile(0.5))
    for v in (0.0, -1.0, 0.0, 5.0):
        h.observe(v)
    assert h.quantile(0.25) == 0.0
    assert abs(h.quantile(1.0) - 5.0) / 5.0 <= metrics.REL_ACCURACY
    with pytest.raises(ValueError):
        h.quantile(1.5)


# --------------------------------------------------------------------- #
# schema stability + validation                                         #
# --------------------------------------------------------------------- #

def test_snapshot_schema_pinned():
    assert metrics.SCHEMA == jmetrics.SCHEMA == "repro.obs/v1"
    assert trace.TRACE_SCHEMA == jtrace.TRACE_SCHEMA == "repro.obs.trace/v1"
    reg = metrics.Registry()
    reg.counter("c", help="h", labels=("k",)).labels(k="v").inc(2)
    reg.gauge("g").labels().set(1.5)
    reg.histogram("lat", labels=("op",)).labels(op="q").observe(0.25)
    doc = reg.snapshot()
    metrics.validate_snapshot(doc)
    jmetrics.validate_snapshot(doc)
    assert sorted(doc) == ["metrics", "schema"]
    assert [m["name"] for m in doc["metrics"]] == ["c", "g", "lat"]
    c, g, lat = doc["metrics"]
    assert sorted(c) == ["help", "kind", "label_names", "name", "series"]
    assert c["series"] == [{"labels": {"k": "v"}, "value": 2.0}]
    assert g["series"] == [{"labels": {}, "value": 1.5}]
    s = lat["series"][0]
    assert sorted(s) == ["count", "labels", "max", "min", "p50", "p95",
                         "p99", "sum"]
    assert s["count"] == 1 and s["sum"] == 0.25
    assert json.loads(json.dumps(doc)) == doc


def test_validate_snapshot_rejections():
    metrics.validate_snapshot({"schema": metrics.SCHEMA, "metrics": []})
    dup = {"name": "x", "kind": "counter", "label_names": [], "series": []}
    bad_hist = {"name": "h", "kind": "histogram", "label_names": [],
                "series": [{"labels": {}, "count": 1}]}
    for bad in ({"schema": "nope", "metrics": []},
                {"schema": metrics.SCHEMA, "metrics": {}},
                {"schema": metrics.SCHEMA, "metrics": [dup, dict(dup)]},
                {"schema": metrics.SCHEMA, "metrics": [bad_hist]}):
        with pytest.raises(ValueError):
            metrics.validate_snapshot(bad)


def test_validate_chrome_trace_rejections():
    tr = trace.Tracer(sync=False, annotate=False)
    with tr.span("a"):
        with tr.span("b", i=1):
            pass
    doc = tr.to_dict()
    trace.validate_chrome_trace(doc)
    jtrace.validate_chrome_trace(doc)
    with pytest.raises(ValueError):
        trace.validate_chrome_trace({"traceEvents": []})   # no schema tag
    bad = json.loads(json.dumps(doc))
    del bad["traceEvents"][0]["dur"]
    with pytest.raises(ValueError):
        trace.validate_chrome_trace(bad)


# --------------------------------------------------------------------- #
# tracer: nesting, sync marking, export, cap                            #
# --------------------------------------------------------------------- #

def test_trace_nesting_and_attrs(tmp_path):
    tr = trace.Tracer(sync=False, annotate=True)
    with tr.span("outer", backend="fdbscan"):
        with tr.span("inner", i=torch.tensor(2)):
            pass
    assert [e["name"] for e in tr.events] == ["inner", "outer"]
    inner, outer = tr.events
    assert outer["args"]["backend"] == "fdbscan"
    assert inner["args"]["i"] == 2
    assert outer["dur"] >= inner["dur"]
    p = tmp_path / "t.json"
    doc = tr.export(str(p))
    trace.validate_chrome_trace(json.loads(p.read_text()))
    assert doc["otherData"]["dropped_events"] == 0


def test_trace_sync_marking():
    tr = trace.Tracer(sync=True, annotate=False)
    with tr.span("synced") as sp:
        sp.watch(torch.arange(8) * 2, (None, [torch.ones(2)]), {"k": 3})
    with tr.span("unsynced"):
        pass
    by_name = {e["name"]: e for e in tr.events}
    assert by_name["synced"]["args"]["sync"] == "blocked"
    assert by_name["unsynced"]["args"]["sync"] == "none"
    # a no-sync tracer never blocks, even with watches registered
    tr2 = trace.Tracer(sync=False, annotate=False)
    with tr2.span("s") as sp:
        sp.watch(torch.arange(4))
    assert tr2.events[0]["args"]["sync"] == "none"


def test_span_lets_errors_through():
    tr = trace.Tracer(sync=True, annotate=True)
    with pytest.raises(RuntimeError, match="boom"):
        with tr.span("fails") as sp:
            sp.watch(torch.ones(3))
            raise RuntimeError("boom")
    assert tr._stack() == []


def test_trace_event_cap():
    tr = trace.Tracer(sync=False, annotate=False, max_events=3)
    for i in range(5):
        with tr.span("s", i=i):
            pass
    assert len(tr.events) == 3
    assert tr.to_dict()["otherData"]["dropped_events"] == 2


# --------------------------------------------------------------------- #
# disabled fast path + scoped installation                              #
# --------------------------------------------------------------------- #

def test_disabled_fast_path_is_noop():
    assert metrics.active() is None and trace.active() is None
    metrics.inc("nope")
    metrics.observe("nope", 1.0)
    metrics.set_gauge("nope", 1.0)
    assert metrics.active() is None
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as sp:
        sp.watch(object())
    trace.watch(object())


def test_instrumented_scopes_and_restores():
    outer_reg = metrics.install(metrics.Registry())
    try:
        with obs.instrumented(sync=True) as (reg, tr):
            assert metrics.active() is reg and trace.active() is tr
            assert reg is not outer_reg
            metrics.inc("inside")
            with trace.span("s"):
                pass
        assert metrics.active() is outer_reg
        assert trace.active() is None
        assert outer_reg.get("inside") is None
    finally:
        metrics.uninstall()


def test_validator_cli(tmp_path):
    reg = metrics.Registry()
    reg.counter("c").labels().inc()
    mpath = tmp_path / "m.json"
    reg.write_json(str(mpath))
    tr = trace.Tracer(sync=False, annotate=False)
    with tr.span("phase"):
        pass
    tpath = tmp_path / "t.json"
    tr.export(str(tpath))
    assert obs_validate.main(["--metrics", str(mpath), "--trace",
                              str(tpath), "--require-span", "phase",
                              "--require-metric", "c"]) == 0
    assert obs_validate.main(["--trace", str(tpath),
                              "--require-span", "absent"]) == 1
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert obs_validate.main(["--metrics", str(bad)]) == 1


# --------------------------------------------------------------------- #
# parity with the reference package's instrumentation                   #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    """The same separated points clustered by ``repro.dbscan`` and by
    ``repro_torch.dbscan(device="cpu")``, each under its own package's
    collectors, with the port also run without any; files written."""
    pts = separated_points(1100, 2, eps=0.05, seed=9)
    out = tmp_path_factory.mktemp("obs")
    dispatch.clear_cache()
    jdispatch.clear_cache()
    bare = repro_torch.dbscan(pts, 0.05, 5, device="cpu")
    dispatch.clear_cache()
    with jobs.instrumented() as (jreg, jtr):
        ref = repro.dbscan(pts, 0.05, 5)
    with obs.instrumented() as (reg, tr):
        port = repro_torch.dbscan(pts, 0.05, 5, device="cpu")
    reg.write_json(str(out / "m.json"))
    tr.export(str(out / "t.json"))
    dispatch.clear_cache()
    jdispatch.clear_cache()
    return dict(ref=ref, port=port, bare=bare, jreg=jreg, jtr=jtr, reg=reg,
                tr=tr, out=out)


def test_counters_equal_reference(parity_runs):
    r = parity_runs
    assert r["port"].backend == r["ref"].backend != "tiled"
    jdoc, doc = r["jreg"].snapshot(), r["reg"].snapshot()
    assert [m["name"] for m in doc["metrics"]] == [
        "dbscan_runs_total", "dbscan_sweeps", "dispatch_index_builds_total",
        "dispatch_plan_cache_misses_total", "dispatch_plans_total",
        "traversal_evals_total", "traversal_iters_total"]
    assert doc == jdoc                  # families, labels and values
    evals = {s["labels"]["phase"]: s["value"] for m in doc["metrics"]
             if m["name"] == "traversal_evals_total" for s in m["series"]}
    assert set(evals) == {"first_pass", "sweep", "border"}
    assert all(s["labels"]["engine"] == "reference" for m in doc["metrics"]
               if m["name"].startswith("traversal_") for s in m["series"])


def test_spans_equal_reference(parity_runs):
    r = parity_runs
    names = [e["name"] for e in r["tr"].events]
    assert names == [e["name"] for e in r["jtr"].events]
    assert names[:3] == ["build", "plan", "traverse"]
    assert names[-3:] == ["border", "finalize", "dbscan"]
    assert names.count("sweep") == r["port"].n_sweeps - 1
    assert ([e["args"] for e in r["tr"].events]
            == [e["args"] for e in r["jtr"].events])


def test_files_pass_both_validators(parity_runs):
    out = parity_runs["out"]
    mdoc = json.loads((out / "m.json").read_text())
    tdoc = json.loads((out / "t.json").read_text())
    jmetrics.validate_snapshot(mdoc)
    jtrace.validate_chrome_trace(tdoc)
    jdoc = parity_runs["jtr"].to_dict()
    trace.validate_chrome_trace(jdoc)
    metrics.validate_snapshot(parity_runs["jreg"].snapshot())
    assert obs_validate.main([
        "--metrics", str(out / "m.json"), "--trace", str(out / "t.json"),
        "--require-span", "sweep", "--require-metric",
        "traversal_evals_total"]) == 0


def test_collectors_change_no_result(parity_runs):
    port, bare = parity_runs["port"], parity_runs["bare"]
    assert torch.equal(port.labels, bare.labels)
    assert torch.equal(port.core_mask, bare.core_mask)
    assert (port.n_clusters, port.n_sweeps, port.n_traversals) == \
        (bare.n_clusters, bare.n_sweeps, bare.n_traversals)
    np.testing.assert_array_equal(np.asarray(parity_runs["ref"].labels),
                                  port.labels.numpy())
    assert metrics.active() is None and trace.active() is None


def test_profiler_session_shows_spans(tmp_path):
    # spans mirror into torch.profiler.record_function, so a capture shows
    # the same phase names on its timeline
    tr = trace.Tracer(sync=True, annotate=True)
    with trace.profiler_session(str(tmp_path)):
        with tr.span("phase_x"):
            torch.ones(8).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "phase_x" for e in doc["traceEvents"])
