"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have, and for the control (the reference
in TF32 in the program's place). The runs skip the harness's look for a
card and drive the rest of a run on the CPU at a tiny size; the control
runs at a size where TF32 flips pairs on every seed here."""
import numpy as np
import pytest
import torch

from bench import control, harness
from bench.test_bench_loops import ROOT, run, scaled_eps, tiny

torch.set_num_threads(1)

repro_torch = pytest.importorskip("repro_torch")
from repro_torch.stream import StreamingDBSCAN  # noqa: E402


def _stale(monkeypatch):
    """Every call returns the answer of the first: state left unchanged."""
    real, first = repro_torch.dbscan, []

    def fake(points, eps, min_pts, **kw):
        if not first:
            first.append(real(points, eps, min_pts, **kw))
        return first[0]
    monkeypatch.setattr(repro_torch, "dbscan", fake)


def _half(monkeypatch):
    """Half of the points left out; the rest come back as noise."""
    real = repro_torch.dbscan

    def fake(points, eps, min_pts, **kw):
        h = points.shape[0] // 2
        res = real(points[:h].contiguous(), eps, min_pts, **kw)
        n = points.shape[0]
        labels = torch.full((n,), -1, dtype=res.labels.dtype)
        core = torch.zeros(n, dtype=torch.bool)
        labels[:h], core[:h] = res.labels, res.core_mask
        return res._replace(labels=labels, core_mask=core)
    monkeypatch.setattr(repro_torch, "dbscan", fake)


def _altered(monkeypatch):
    """One core point's label changed where it is produced."""
    real = repro_torch.dbscan

    def fake(points, eps, min_pts, **kw):
        res = real(points, eps, min_pts, **kw)
        labels = res.labels.clone()
        i = int(torch.nonzero(res.core_mask)[0])
        labels[i] = res.n_clusters
        return res._replace(labels=labels, n_clusters=res.n_clusters + 1)
    monkeypatch.setattr(repro_torch, "dbscan", fake)


@pytest.mark.parametrize("workload", ["hacc.fresh", "porto.minpts_sweep"])
@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_a_broken_clustering_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res, limits, log = run(tiny(workload))
    assert res["correct"] is False, limits


def _insert_noop(monkeypatch):
    monkeypatch.setattr(StreamingDBSCAN, "insert", lambda self, pts: self)


def _insert_half(monkeypatch):
    real = StreamingDBSCAN.insert
    monkeypatch.setattr(StreamingDBSCAN, "insert",
                        lambda self, pts: real(self, pts[:len(pts) // 2]))


def _query_altered(monkeypatch):
    real = StreamingDBSCAN.query

    def fake(self, pts):
        res = real(self, pts)
        labels = res.labels.copy()
        i = int(np.nonzero(labels >= 0)[0][0])
        labels[i] += 1
        return res._replace(labels=labels)
    monkeypatch.setattr(StreamingDBSCAN, "query", fake)


def _snapshot_altered(monkeypatch):
    real = StreamingDBSCAN.snapshot

    def fake(self, **kw):
        res = real(self, **kw)
        core = res.core_mask.clone()
        core[int(torch.nonzero(core)[0])] = False
        return res._replace(core_mask=core)
    monkeypatch.setattr(StreamingDBSCAN, "snapshot", fake)


@pytest.mark.parametrize("fault", [_insert_noop, _insert_half,
                                   _query_altered, _snapshot_altered])
def test_a_broken_stream_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res, limits, log = run(tiny("porto.stream"))
    assert res["correct"] is False, limits


CONTROL = [("porto.minpts_sweep", 20000, (1, 2, 3)),
           ("hacc.minpts_sweep", 16384, (4, 5, 6)),
           ("porto.stream", 20000, (7, 8, 9))]


@pytest.mark.parametrize("workload,n,seeds", CONTROL)
def test_the_control_is_not_correct(workload, n, seeds):
    cell = harness.load_cell(ROOT, workload)
    cfg = dict(cell.cfg, n=n, eps=scaled_eps(cell.cfg, n))
    mix = dict(cell.mix, batch=1024)
    cell = cell._replace(cfg=cfg, mix=mix)
    for seed in seeds:
        got = control.control(cell, seed, "cpu", steps=4)
        assert not harness.passes(harness.limits_of(got)), (seed, got)
