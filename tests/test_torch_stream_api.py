"""The streaming index's entry points in the port against the reference's,
on the CPU, zero tolerance: a cold start from ``None`` under a sliding
window, a delete that splits a component, the ``stream`` backend of
``dbscan``, ``tenant_handles`` (one index build however many tenants),
and the ``obs`` counters and span names of one instrumented op sequence
(timings excluded). The op
sequences themselves are in ``tests/test_torch_stream.py``, whose
helpers and point sets this file shares."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro import obs as jobs  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.stream import StreamingDBSCAN as JStream  # noqa: E402
from repro.stream import index as jindex  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.stream import index as tindex  # noqa: E402

from test_torch_stream import (BATCH, BLOBS, BUFFER_MAX,  # noqa: E402
                               EPS_BLOBS, MP_BLOBS, N_BOOT,
                               _assert_same_snapshot, _assert_same_state,
                               _port, _run_ops)


def test_cold_start_window_matches_reference():
    """A cold start from ``None`` under a sliding window: every insert
    expires the oldest points; the default buffer never seals, so the
    buffer level carries tombstones."""
    ops = [("insert",)] * 4 + [("query",), ("delete", 0.2), ("insert",),
                               ("query",), ("snapshot",)]
    ref, port = _run_ops(BLOBS, EPS_BLOBS, MP_BLOBS, 0, ops, window=60)
    assert ref.n_tombstoned > 0 and ref.n_points == 5 * BATCH


def test_delete_splits_a_component():
    """Deleting the core that bridges two groups splits their cluster:
    the repair resets the component and re-derives both halves."""
    blob = np.array([[0.0, 0.0], [0.03, 0.0], [-0.03, 0.0], [0.0, 0.03]],
                    np.float32)
    pts = np.concatenate([blob, blob + np.float32([0.18, 0.0]),
                          [[0.09, 0.0]]]).astype(np.float32)
    ref, port = JStream(pts, 0.1, 4), _port(pts, 0.1, 4)
    _assert_same_snapshot(ref.snapshot(), port.snapshot(), "joined")
    assert port.snapshot().n_clusters == 1
    assert ref.delete([8]) == port.delete([8]) == 1
    _assert_same_state(ref, port, "split")
    _assert_same_snapshot(ref.snapshot(), port.snapshot(), "split")
    assert port.snapshot().n_clusters == 2 and port.n_repair_sweeps > 0


def test_dbscan_stream_backend_matches_reference():
    pts = BLOBS[:N_BOOT]
    for star in (False, True):
        ref = jdispatch.dbscan(pts, EPS_BLOBS, MP_BLOBS, algorithm="stream",
                               star=star)
        res = repro_torch.dbscan(pts, EPS_BLOBS, MP_BLOBS,
                                 algorithm="stream", star=star,
                                 device="cpu")
        assert res.backend == "stream"
        _assert_same_snapshot(ref, res, f"star={star}")
    with pytest.raises(ValueError, match="stream backend"):
        repro_torch.dbscan(pts, EPS_BLOBS, MP_BLOBS, algorithm="stream",
                           frontier=False, device="cpu")
    with pytest.raises(ValueError, match="d in"):
        repro_torch.dbscan(np.zeros((8, 4), np.float32), 0.1, 2,
                           algorithm="stream", device="cpu")


def test_tenant_handles_share_one_index_build():
    pts = BLOBS[:N_BOOT]
    spec = {"tight": {"eps": 0.04, "min_pts": 5},
            "loose": {"eps": EPS_BLOBS, "min_pts": MP_BLOBS,
                      "buffer_max": BUFFER_MAX}}
    dispatch.clear_cache()
    jdispatch.clear_cache()
    with jobs.instrumented() as (jreg, _):
        refs = jdispatch.tenant_handles(pts, spec)
    with obs.instrumented() as (reg, _):
        ports = dispatch.tenant_handles(pts, spec, device="cpu")
    for r in (reg, jreg):
        assert r.get("dispatch_index_builds_total",
                     index="fdbscan").value == 1.0
    for name in spec:
        _assert_same_state(refs[name], ports[name], name)
        batch = BLOBS[N_BOOT:N_BOOT + BATCH]
        refs[name].insert(batch)
        ports[name].insert(batch)
        _assert_same_state(refs[name], ports[name], name)
    dispatch.clear_cache()
    jdispatch.clear_cache()
    with pytest.raises(ValueError, match="at least one tenant"):
        dispatch.tenant_handles(pts, {}, device="cpu")


def _timing_free(doc):
    """A metrics snapshot without the wall-clock histograms' values."""
    out = []
    for m in doc["metrics"]:
        if m["name"].endswith("_seconds"):
            m = dict(m, series=[{"labels": s["labels"],
                                 "count": s["count"]} for s in m["series"]])
        out.append(m)
    return out


def test_obs_counters_and_spans_equal_reference(tmp_path):
    pts = BLOBS
    dispatch.clear_cache()
    jdispatch.clear_cache()
    tindex._seen_programs.clear()
    jindex._seen_programs.clear()
    runs = {}
    for side, inst, make in (("ref", jobs.instrumented, JStream),
                             ("port", obs.instrumented, _port)):
        with inst() as (reg, tr):
            h = make(pts[:N_BOOT], EPS_BLOBS, MP_BLOBS, buffer_max=BUFFER_MAX,
                     wal=str(tmp_path / f"{side}.wal"),
                     checkpoint_path=str(tmp_path / f"{side}.npz"))
            h.insert(pts[N_BOOT:N_BOOT + BATCH])
            h.query(pts[:64])
            h.delete(np.arange(0, N_BOOT, 7))
            h.merge()
            h.expire(30)
            h.compact()
            h.snapshot()
            h.checkpoint()
            h._wal.close()
        runs[side] = (reg.snapshot(), [e["name"] for e in tr.events],
                      [{k: v for k, v in e["args"].items() if k != "path"}
                       for e in tr.events])
    (jdoc, jnames, jargs), (doc, names, args) = runs["ref"], runs["port"]
    assert _timing_free(doc) == _timing_free(jdoc)
    assert names == jnames and args == jargs
    fams = {m["name"] for m in doc["metrics"]}
    assert {"stream_inserts_total", "stream_repair_sweeps_total",
            "stream_compactions_total", "stream_query_recompiles_total",
            "wal_appends_total", "checkpoints_total"} <= fams
    assert {"stream.insert", "stream.repair", "stream.delete",
            "stream.expire", "stream.merge", "stream.snapshot",
            "stream.checkpoint"} <= set(names)
