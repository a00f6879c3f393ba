"""The port stands alone: no module of ``src/repro_torch`` (the
``stream``, ``serve`` and ``launch`` packages included) and not
``chip_smoke.py`` imports JAX or the reference package, importing and
running the port (clustering, neighbor queries, a streaming handle with a
WAL, a checkpoint and a restore, a two-tenant server, the serving CLI,
under the port's own collectors, a tuned plan and the clustering CLI)
loads neither, and without a CUDA device
the entry points refuse to run unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_reference():
    seen = 0
    for path in _sources():
        assert os.path.exists(path), path
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
        seen += 1
    assert seen >= 15


def test_running_the_port_loads_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import os
        import sys
        import tempfile
        import numpy as np
        import repro_torch
        import repro_torch.stream
        from repro_torch import obs
        from repro_torch.data import pointclouds
        pts = pointclouds.load("blobs", 300)
        with obs.instrumented() as (reg, tracer):
            for algorithm in ("auto", "fdbscan-densebox"):
                res = repro_torch.dbscan(pts, 0.05, 5, algorithm=algorithm,
                                         device="cpu")
                assert res.n_clusters > 0
            knn = repro_torch.neighbors.knn(pts, 3, device="cpu")
            counts = repro_torch.neighbors.neighbor_count(pts, 0.05, cap=5,
                                                          device="cpu")
        assert knn.indices.shape == (300, 3) and counts.shape == (300,)
        assert reg.get("dbscan_runs_total", backend="fdbscan-densebox")
        assert [e["name"] for e in tracer.events][-1] == "plan"
        with obs.instrumented() as (reg, tracer):
            with tempfile.TemporaryDirectory() as tmp:
                h = repro_torch.stream_handle(
                    pts[:200], 0.05, 5, device="cpu", buffer_max=40,
                    wal=os.path.join(tmp, "w"),
                    checkpoint_path=os.path.join(tmp, "c.npz"))
                h.insert(pts[200:])
                h.delete([0, 1, 2])
                q = h.query(pts[:10])
                snap = h.snapshot()
                back = repro_torch.stream.StreamingDBSCAN.restore(
                    os.path.join(tmp, "c.npz"), wal=os.path.join(tmp, "w"),
                    device="cpu")
                assert (back.snapshot().labels == snap.labels).all()
        assert q.labels.shape == (10,) and snap.labels.shape == (297,)
        assert reg.get("stream_inserts_total").value == 2.0
        from repro_torch import serve
        from repro_torch.launch import serve as cli
        with obs.instrumented() as (reg, tracer):
            with tempfile.TemporaryDirectory() as tmp:
                with serve.Server(pts[:200], [("a", 0.05, 5), ("b", 0.1, 3)],
                                  durability_dir=tmp, device="cpu") as srv:
                    ack = srv.insert(pts[200:], timeout=60)
                    rep = srv.query(pts[:10], tenant="b", timeout=60)
                back = serve.Server.restore([("a", 0.05, 5), ("b", 0.1, 3)],
                                            durability_dir=tmp, device="cpu")
                again = back.query(pts[:10], tenant="b", timeout=60)
                back.shutdown()
        assert ack.watermark == 300 and rep.version == 1
        assert (again.labels == rep.labels).all()
        assert reg.get("serve_snapshot_publishes_total", tenant="a")
        stats = cli.main(["--device", "cpu", "--n", "400", "--steps", "4",
                          "--tenants", "a:0.05:5,b:0.1:3", "--validate"])
        assert stats["steps"] == 4
        from repro_torch.core import dispatch, tune
        from repro_torch.launch import cluster
        os.environ["REPRO_TUNE"] = "search"
        p = dispatch.plan(pts, 0.05, 5, algorithm="pallas-tree",
                          device="cpu")
        assert p.tune.config.source == "search"
        res = repro_torch.dbscan(pts, 0.05, 5, query_plan=p)
        assert p.tune.depth_rank is not None and res.n_clusters > 0
        del os.environ["REPRO_TUNE"]
        assert tune.mode() == "heuristic"
        dispatch.clear_cache()          # the plan LRU holds the search's
        out = cluster.main(["--data", "blobs", "-n", "300", "--eps", "0.05",
                            "--minpts", "5", "--algorithm", "pallas-tree",
                            "--device", "cpu"])
        assert out["tuned_config"]["source"] == "heuristic"
        out = cluster.main(["--data", "blobs", "-n", "300", "--eps", "0.05",
                            "--minpts", "5", "--algorithm", "gdbscan",
                            "--device", "cpu"])
        assert out["n_clusters"] > 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("isolated")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_no_cuda_and_no_device_raises(monkeypatch):
    import numpy as np
    import repro_torch
    from repro_torch.core import dispatch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).uniform(0, 1, (50, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.dbscan(pts, 0.1, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch.plan(pts, 0.1, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.dbscan(pts, 0.1, 3, algorithm="fdbscan")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.neighbors.knn(pts, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.neighbors.neighbor_count(pts, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.dbscan(pts, 0.1, 3, algorithm="stream")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.stream_handle(pts, 0.1, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dispatch.tenant_handles(pts, {"a": {"eps": 0.1, "min_pts": 3}})
    from repro_torch.stream import StreamingDBSCAN
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingDBSCAN(None, 0.1, 3)
    from repro_torch import serve
    from repro_torch.launch import serve as cli
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Server(pts, [("a", 0.1, 3)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_views(pts, [("a", 0.1, 3)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.restore_views([("a", 0.1, 3)], durability_dir="unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.IndexSnapshot(pts, np.zeros(50, np.int64), 0.1, 3)
    with pytest.raises(SystemExit) as ei:
        cli.main(["--n", "64"])
    assert ei.value.code == 2
    from repro_torch.launch import cluster
    with pytest.raises(SystemExit) as ei:
        cluster.main(["--eps", "0.1", "--minpts", "3"])
    assert ei.value.code == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.core.gdbscan(pts, 0.1, 3)
    snap = serve.freeze(repro_torch.stream_handle(pts, 0.1, 3, device="cpu"))
    assert snap.device.type == "cpu" and snap.query(pts).labels.shape == (50,)
    assert repro_torch.dbscan(pts, 0.1, 3, device="cpu").labels.shape == (50,)
    assert repro_torch.stream_handle(pts, 0.1, 3, device="cpu").n_points == 50
