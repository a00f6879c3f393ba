"""The port's serving plane (``repro_torch.serve``) against the
reference's (``repro.serve``) on the CPU, zero tolerance.

  * snapshots: ``freeze_view`` byte-equal to the reference's
    ``FrozenState``; ``IndexSnapshot.query`` and ``stats()`` byte-equal to
    the reference snapshot built from the same frozen state, on
    ``tests/test_serve.py``'s probe mix (exact duplicates of residents,
    ±1e6 probes, ``nextafter`` + 50), on empty batches and empty
    snapshots, at ``min_pts = 1``, and with the exact pass cut into
    chunks of a few points; immutability under later inserts; the store's
    versioning;
  * micro-batching: the same flush sequence, batch targets and deadlines
    under scripts with explicit ``now`` values; ``bucket_size`` over
    1..4096;
  * admission: the same sheds (kind, reason, depth, limit, retry hint)
    and the same stats;
  * tenants: one index build for all views;
  * the server: replies, versions and insert acknowledgements equal to
    the reference ``Server``'s for the same inserts, and the reference's
    server behaviours (malformed requests, inline empty queries, a
    single tenant, drain and shed on shutdown, concurrent writes).

The snapshot is held to the reference's *snapshot*, not to the streaming
handle's ``query``: the snapshot's exact pass rounds as eager float32,
the handle's walk as a fused multiply-add chain, and the two agree only
where no pair lies within rounding of eps.

The reference's ``test_stream_query_recompiles_flat_at_steady_state``
has no counterpart: it tests the JAX jit cache, and the port compiles
nothing per probe shape.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.serve import snapshot as jsnapshot  # noqa: E402
from repro.serve.batching import Request as JRequest  # noqa: E402
from repro.stream import StreamingDBSCAN as JStream  # noqa: E402

from repro_torch import obs, serve  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.serve import snapshot as tsnapshot  # noqa: E402
from repro_torch.serve.batching import Request  # noqa: E402
from repro_torch.serve.tenants import build_views, check_specs  # noqa: E402

EPS, MINPTS = 0.05, 6
# the server parity runs: a small bootstrap and batches of BATCH points
# (the reference compiles its walks per level and probe shape)
BLOBS = pointclouds.load("blobs", 500, seed=4)
N_BOOT, BATCH = 96, 24
SPECS = [("tight", 0.03, 8), ("loose", 0.08, 4)]


def _handle(pts, eps=EPS, min_pts=MINPTS, **kw):
    return dispatch.stream_handle(pts, eps, min_pts, device="cpu", **kw)


def _probe_mix(pts, k, seed, eps=EPS):
    """Jittered resident samples + exact duplicates + far out-of-range
    (``tests/test_serve.py``'s)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(pts), k)
    jit = rng.normal(0.0, 0.5 * eps, (k, pts.shape[1])).astype(np.float32)
    probes = pts[idx] + jit
    probes[: k // 4] = pts[rng.integers(0, len(pts), k // 4)]  # exact dups
    far = np.full((4, pts.shape[1]), 1e6, np.float32)
    far[1] *= -1.0
    far[2, 0] = -1e6
    far[3] = np.nextafter(np.float32(pts.max()), np.float32(np.inf)) + 50.0
    return np.ascontiguousarray(np.concatenate([probes, far]), np.float32)


def _assert_same(ref, got, ctx=""):
    for f in ("labels", "counts", "would_be_core"):
        x, y = np.asarray(getattr(ref, f)), getattr(got, f)
        assert isinstance(y, np.ndarray), (ctx, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {f} diverged")


def _reference_snapshot(snap_or_state, eps, min_pts, version=0):
    """The reference's snapshot over the same frozen state (host copies)."""
    s = snap_or_state
    return jsnapshot.IndexSnapshot(s.pts.numpy(), s.vals.numpy(), eps,
                                   min_pts, version=version,
                                   watermark=s.watermark)


# ---------------------------------------------------------------------- #
# snapshots                                                              #
# ---------------------------------------------------------------------- #

def test_freeze_view_matches_reference():
    """Bootstrap, inserts, a delete and an expiry in both packages: the
    frozen states are byte-equal after each."""
    ref = JStream(BLOBS[:N_BOOT], EPS, MINPTS)
    port = _handle(BLOBS[:N_BOOT])
    steps = [("insert", BLOBS[N_BOOT:N_BOOT + BATCH]),
             ("delete", np.arange(0, N_BOOT, 9)), ("expire", 20)]
    for what, arg in [("bootstrap", None)] + steps:
        if arg is not None:
            for h in (ref, port):
                getattr(h, what)(arg)
        a, b = ref.freeze_view(), port.freeze_view()
        assert isinstance(b, serve.FrozenState)
        assert b.pts.dtype == torch.float32 and b.vals.dtype == torch.int64
        np.testing.assert_array_equal(a.pts, b.pts.numpy(), err_msg=what)
        np.testing.assert_array_equal(a.vals, b.vals.numpy(), err_msg=what)
        assert (a.watermark, a.n_tombstoned) == (b.watermark,
                                                 b.n_tombstoned), what
        snap = serve.IndexSnapshot.build(b, EPS, MINPTS, version=3)
        jsnap = jserve.IndexSnapshot.build(a, EPS, MINPTS, version=3)
        probes = _probe_mix(BLOBS, 64, seed=1)
        _assert_same(jsnap.query(probes), snap.query(probes), what)
        assert snap.stats() == jsnap.stats()


@pytest.mark.parametrize("dataset,eps,min_pts", [
    ("portotaxi_like", 0.02, 10),
    ("blobs", 0.05, 6),
    ("hacc_like", 0.05, 8),         # 3-d: 125-cell neighborhood path
])
def test_snapshot_matches_reference(dataset, eps, min_pts, monkeypatch):
    pts = pointclouds.load(dataset, 1500, seed=3)
    h = _handle(pts, eps, min_pts)
    snap = serve.freeze(h, version=1)
    assert snap.device == torch.device("cpu")
    ref = _reference_snapshot(h.freeze_view(), eps, min_pts, version=1)
    probes = _probe_mix(pts, 400, seed=5, eps=eps)
    _assert_same(ref.query(probes), snap.query(probes), f"{dataset}")
    assert snap.stats() == ref.stats()
    assert snap.version == 1 and snap.watermark == h.n_points

    # the exact pass in chunks of a few gathered points: the same answer,
    # and the same count of probes that needed it
    with obs.instrumented() as (reg, _):
        monkeypatch.setattr(tsnapshot, "_EXACT_POINTS", 5)
        syncs = tsnapshot.IndexSnapshot.host_syncs
        _assert_same(ref.query(probes), snap.query(probes), "chunked")
        monkeypatch.undo()
    with jobs.instrumented() as (jreg, _):
        ref.query(probes)
    flagged = reg.get("serve_snapshot_exact_probes_total").value
    assert flagged == jreg.get("serve_snapshot_exact_probes_total").value
    assert flagged > 0
    # a flush with partial-cell pairs syncs three times: the pairs, the
    # gathered total, the result copy
    assert tsnapshot.IndexSnapshot.host_syncs - syncs == 3

    # mutate the handle: the old snapshot keeps answering for the old
    # state while a re-freeze matches the reference on the new one
    more = pointclouds.load(dataset, 1700, seed=3)[1500:]
    old = snap.query(probes)
    h.insert(more)
    _assert_same(old, snap.query(probes), f"{dataset} immutable")
    ref2 = _reference_snapshot(h.freeze_view(), eps, min_pts, version=2)
    _assert_same(ref2.query(probes), serve.freeze(h, version=2).query(probes),
                 f"{dataset} refrozen")


def test_snapshot_empty_and_edge_cases():
    cases = {}
    for side, mod, kw in (("ref", jserve, {}),
                          ("port", serve, {"device": "cpu"})):
        empty = mod.IndexSnapshot(np.zeros((0, 2), np.float32),
                                  np.zeros(0, np.int64), EPS, MINPTS, **kw)
        lone = mod.IndexSnapshot(np.zeros((0, 2), np.float32),
                                 np.zeros(0, np.int64), EPS, 1, **kw)
        cases[side] = [empty.query(np.zeros((3, 2), np.float32)),
                       lone.query(np.zeros((2, 2), np.float32)),
                       empty.stats()]
    for a, b in zip(cases["ref"][:2], cases["port"][:2]):
        _assert_same(a, b, "empty snapshot")
    assert cases["port"][1].would_be_core.all()     # min_pts == 1
    assert cases["port"][2] == cases["ref"][2]

    pts = pointclouds.load("blobs", 300, seed=0)
    h = _handle(pts)
    snap = serve.freeze(h)
    ref = _reference_snapshot(h.freeze_view(), EPS, MINPTS)
    for probes in (np.zeros((0, 2), np.float32),    # empty probe batch
                   pts[:1], torch.from_numpy(pts[:7])):
        _assert_same(ref.query(np.asarray(probes)), snap.query(probes),
                     f"{len(probes)} probes")
    mp1 = serve.IndexSnapshot(*h.freeze_view()[:2], EPS, 1)
    ref1 = jserve.IndexSnapshot(*(t.numpy() for t in h.freeze_view()[:2]),
                                EPS, 1)
    probes = _probe_mix(pts, 100, seed=2)
    _assert_same(ref1.query(probes), mp1.query(probes), "min_pts=1")

    vals = np.zeros(len(pts), np.int64)
    for args, msg in [((pts, vals, 0.0, MINPTS), "eps"),
                      ((pts, vals, EPS, 0), "min_pts"),
                      ((pts, np.zeros(7, np.int64), EPS, MINPTS), "mismatch"),
                      ((pts[:, :1], vals, EPS, MINPTS), "points")]:
        with pytest.raises(ValueError, match=msg):
            jserve.IndexSnapshot(*args)
        with pytest.raises(ValueError, match=msg):
            serve.IndexSnapshot(*args, device="cpu")
    for bad, msg in [(np.zeros((4, 3), np.float32), "dimensionality"),
                     (np.full((4, 2), np.nan, np.float32), "finite")]:
        with pytest.raises(ValueError, match=msg):
            ref.query(bad)
        with pytest.raises(ValueError, match=msg):
            snap.query(bad)


def test_snapshot_store_versioning():
    pts = pointclouds.load("blobs", 200, seed=1)
    h = _handle(pts)
    store = serve.SnapshotStore(keep=3)
    assert store.version == -1 and store.current() is None
    for v in (0, 1, 2, 3):
        store.publish(serve.freeze(h, version=v))
    assert store.version == 3
    assert store.current().version == 3
    assert store.get(0) is None                 # evicted (keep=3)
    assert store.get(1).version == 1
    with pytest.raises(ValueError, match="monotonic"):
        store.publish(serve.freeze(h, version=3))   # stale writer
    assert store.version == 3                   # rejected publish: no swap


# ---------------------------------------------------------------------- #
# micro-batching                                                         #
# ---------------------------------------------------------------------- #

def _script(seed: int, n: int = 120):
    """(op, now, size) steps: adds of 1..300 probes at jittered arrival
    gaps (bursts and lulls), polls, and a drain at the end."""
    rng = np.random.default_rng(seed)
    now, out = 0.0, []
    for _ in range(n):
        now += float(rng.choice([1e-5, 2e-4, 3e-3, 0.05]))
        r = rng.random()
        if r < 0.6:
            out.append(("add", now, int(rng.integers(1, 300))))
        elif r < 0.9:
            out.append(("ready", now, 0))
        else:
            out.append(("deadline", now, 0))
    out.append(("drain", now + 1.0, 0))
    return out


def _run_batcher(mod, req_cls, cfg, script):
    b = mod.MicroBatcher(**cfg)
    trace = []
    for op, now, k in script:
        if op == "add":
            hot = b.add(req_cls(np.full((k, 2), len(trace), np.float32),
                                None, now))
            trace.append(("add", hot, b.target_points(), b.pending_points))
        elif op == "ready":
            fl = b.ready(now)
            trace.append(None if fl is None else
                         (fl.reason, [len(r.pts) for r in fl.requests],
                          fl.pts.tobytes(), b.pending_points))
        elif op == "deadline":
            trace.append(("deadline", b.next_deadline(now)))
        else:
            trace.append([(f.reason, len(f.pts), f.pts.tobytes())
                          for f in b.drain(now)])
    return trace


@pytest.mark.parametrize("cfg", [
    dict(max_batch=8, max_delay_s=0.01, adaptive=False),
    dict(max_batch=4, max_delay_s=10.0, adaptive=False),
    dict(max_batch=512, max_delay_s=0.002, adaptive=True),
    dict(max_batch=4096, max_delay_s=0.002, adaptive=True),
], ids=["full-deadline", "atomic", "adaptive-512", "adaptive-4096"])
@pytest.mark.parametrize("seed", [0, 1])
def test_batcher_flush_sequence_matches_reference(cfg, seed):
    script = _script(seed)
    ref = _run_batcher(jserve, JRequest, cfg, script)
    port = _run_batcher(serve, Request, cfg, script)
    assert port == ref
    assert any(t is not None and t[0] in ("full", "deadline")
               for t in port if isinstance(t, tuple))


def test_bucket_size_matches_reference():
    got = [serve.bucket_size(k) for k in range(1, 4097)]
    assert got == [jserve.bucket_size(k) for k in range(1, 4097)]
    assert all(g >= k for k, g in enumerate(got, 1))


# ---------------------------------------------------------------------- #
# admission control                                                      #
# ---------------------------------------------------------------------- #

def _run_admission(mod, seed: int):
    a = mod.AdmissionController(max_pending_requests=3,
                                max_pending_points=100,
                                max_pending_inserts=2, retry_after_s=0.25)
    rng = np.random.default_rng(seed)
    held_q, held_i, out = [], 0, []
    for step in range(200):
        r = rng.random()
        try:
            if step == 180:
                a.close()
                out.append("closed")
            elif r < 0.35:
                k = int(rng.integers(1, 60))
                a.admit_query(k)
                held_q.append(k)
                out.append(("q", k))
            elif r < 0.5 and held_q:
                a.release_query(held_q.pop(0))
                out.append("rq")
            elif r < 0.65:
                a.admit_insert()
                held_i += 1
                out.append("i")
            elif r < 0.75 and held_i:
                a.release_insert()
                held_i -= 1
                out.append("ri")
            else:
                a.observe(("query", "insert")[step % 2],
                          float(rng.uniform(1e-4, 0.5)),
                          tenant=("t0", "t1")[step % 3 == 0])
        except mod.Overloaded as e:
            out.append((e.kind, e.reason, e.depth, e.limit,
                        e.retry_after_s, str(e)))
    st = a.stats(tenants=("t0", "t1"))
    return out, {k: ("nan" if v != v else v) if isinstance(v, float) else v
                 for k, v in st.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_sheds_like_reference(seed):
    ref = _run_admission(jserve, seed)
    port = _run_admission(serve, seed)
    assert port == ref
    kinds = {t[:2] for t in port[0] if isinstance(t, tuple) and len(t) > 2}
    assert ("query", "requests") in kinds and ("insert", "inserts") in kinds


# ---------------------------------------------------------------------- #
# tenants                                                                #
# ---------------------------------------------------------------------- #

def test_check_specs_validation():
    ok = check_specs([("a", 0.1, 5), serve.TenantSpec("b", 0.2, 3)])
    assert [s.name for s in ok] == ["a", "b"]
    for bad, msg in [([], "at least one"), ([("a/b", 0.1, 5)], "must match"),
                     ([("a", 0.1, 5), ("a", 0.2, 3)], "duplicate"),
                     ([("a", 0.0, 5)], "eps"), ([("a", 0.1, 0)], "min_pts")]:
        with pytest.raises(ValueError, match=msg):
            check_specs(bad)


def test_build_views_makes_one_index_build():
    pts = pointclouds.load("blobs", 600, seed=2)
    dispatch.clear_cache()
    with obs.instrumented() as (reg, _):
        views = build_views(pts, [("tight", 0.03, 8), ("loose", 0.08, 4)],
                            device="cpu")
        c = reg.get("dispatch_index_builds_total", index="fdbscan")
        assert c is not None and c.value == 1.0     # N tenants, one build
        assert reg.get("serve_snapshot_publishes_total",
                       tenant="loose").value == 1.0
    dispatch.clear_cache()
    probes = _probe_mix(pts, 200, seed=9)
    for v in views:
        assert v.store.version == 0
        assert v.handle.device == torch.device("cpu")
        ref = _reference_snapshot(v.handle.freeze_view(), v.spec.eps,
                                  v.spec.min_pts)
        _assert_same(ref.query(probes), v.store.current().query(probes),
                     v.name)
    t_lab, l_lab = (v.store.current().query(probes).labels for v in views)
    assert np.all((t_lab == -1) | (l_lab != -1))


# ---------------------------------------------------------------------- #
# the server                                                             #
# ---------------------------------------------------------------------- #

def test_server_matches_reference_server():
    """The same bootstrap and inserts through both servers: every reply,
    version and acknowledgement is equal."""
    pts = BLOBS
    jcfg = jserve.ServerConfig(max_batch=512, max_delay_s=0.001)
    cfg = serve.ServerConfig(max_batch=512, max_delay_s=0.001)
    assert cfg == tuple(jcfg)
    jdispatch.clear_cache()
    dispatch.clear_cache()
    with jserve.Server(pts[:N_BOOT], SPECS, config=jcfg) as ref, \
            serve.Server(pts[:N_BOOT], SPECS, config=cfg,
                         device="cpu") as port:
        assert port.tenants == ref.tenants
        for step in range(3):
            probes = _probe_mix(pts[:N_BOOT + step * BATCH], 80,
                                seed=11 + step)
            for name, _, _ in SPECS:
                a = ref.query(probes, tenant=name, timeout=120)
                b = port.query(probes, tenant=name, timeout=120)
                _assert_same(a, b, f"{name} step {step}")
                assert (b.version, b.tenant) == (a.version, a.tenant)
            batch = pts[N_BOOT + step * BATCH:N_BOOT + (step + 1) * BATCH]
            ra = ref.insert(batch, timeout=120)
            rb = port.insert(batch, timeout=120)
            assert rb == ra and rb.watermark == N_BOOT + (step + 1) * BATCH
        sa, sb = ref.stats(), port.stats()
        for key in ("pending_requests", "pending_points", "pending_inserts",
                    "shed", "completed", "apply_failures"):
            assert sb[key] == sa[key], key
        assert sb["tenants"] == sa["tenants"]
    jdispatch.clear_cache()
    dispatch.clear_cache()


FAST_CFG = serve.ServerConfig(max_batch=512, max_delay_s=0.001)


@pytest.fixture(scope="module")
def served():
    pts = pointclouds.load("blobs", 500, seed=4)
    srv = serve.Server(pts[:400], SPECS, config=FAST_CFG, device="cpu")
    yield srv, pts
    srv.shutdown()


def test_server_insert_ack_implies_visibility(served):
    srv, pts = served
    before = {v.name: v.store.version for v in srv._views}
    rep = srv.insert(pts[400:450], timeout=60)
    assert rep.watermark == 450
    for v in srv._views:
        assert rep.versions[v.name] > before[v.name]
    probes = _probe_mix(pts, 100, seed=13)
    for v in srv._views:
        ref = _reference_snapshot(v.handle.freeze_view(), v.spec.eps,
                                  v.spec.min_pts)
        _assert_same(ref.query(probes),
                     srv.query(probes, tenant=v.name, timeout=60), v.name)


def test_server_rejects_malformed_requests(served):
    srv, pts = served
    with pytest.raises(ValueError, match="unknown tenant"):
        srv.submit_query(pts[:4], tenant="nope")
    with pytest.raises(ValueError, match="pass tenant="):
        srv.submit_query(pts[:4])               # ambiguous: two tenants
    with pytest.raises(ValueError, match="finite"):
        srv.submit_query(np.full((4, 2), np.inf, np.float32),
                         tenant="tight")
    with pytest.raises(ValueError, match="max_batch"):
        srv.submit_query(np.zeros((FAST_CFG.max_batch + 1, 2), np.float32),
                         tenant="tight")
    with pytest.raises(ValueError, match="dimensionality"):
        srv.submit_query(np.zeros((4, 3), np.float32), tenant="tight")
    with pytest.raises(ValueError):
        srv.submit_insert(np.zeros((0, 2), np.float32))     # empty insert
    rep = srv.query(np.zeros((0, 2), np.float32), tenant="tight", timeout=5)
    assert rep.labels.shape == (0,) and rep.tenant == "tight"
    st = srv.stats()
    assert st["pending_requests"] == 0 and st["pending_inserts"] == 0


def test_server_queries_survive_concurrent_writes(served):
    """The query plane never blocks behind the writer, answers stay exact
    for *some* published version, and the versions any single client
    observes never go backwards."""
    srv, pts = served
    probes = _probe_mix(pts, 64, seed=17)
    refs = {}

    def snapshot_refs():
        for v in srv._views:
            snap = v.store.current()
            refs.setdefault((v.name, snap.version), snap.query(probes))

    snapshot_refs()
    stop = threading.Event()
    errors: list = []

    def writer():
        rng = np.random.default_rng(23)
        try:
            while not stop.is_set():
                batch = pts[rng.integers(0, len(pts), 20)] \
                    + rng.normal(0, 0.01, (20, 2)).astype(np.float32)
                srv.insert(batch.astype(np.float32), timeout=60)
                snapshot_refs()
        except Exception as e:                  # pragma: no cover
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    try:
        last = {v.name: -1 for v in srv._views}
        deadline = time.monotonic() + 3.0
        n_done = 0
        while time.monotonic() < deadline:
            for v in srv._views:
                rep = srv.query(probes, tenant=v.name, timeout=60)
                assert rep.version >= last[v.name], "version went backwards"
                last[v.name] = rep.version
                ref = refs.get((v.name, rep.version))
                if ref is not None:             # raced publishes may skip
                    _assert_same(ref, rep, f"{v.name}@v{rep.version}")
                n_done += 1
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive()
    assert not errors, errors
    assert n_done > 10


def test_server_single_tenant_and_shutdown():
    pts = pointclouds.load("blobs", 300, seed=6)
    with serve.Server(pts, [("only", EPS, MINPTS)], config=FAST_CFG,
                      device="cpu") as srv:
        rep = srv.query(pts[:16], timeout=60)
        assert rep.tenant == "only" and rep.version == 0
        fut = srv.submit_query(pts[:32])
    assert fut.result(timeout=10).tenant == "only"  # admitted work drained
    assert srv.stats()["stopped"]
    with pytest.raises(serve.Overloaded) as ei:     # new work shed, typed
        srv.submit_query(pts[:4])
    assert ei.value.reason == "shutdown"
    with pytest.raises(serve.Overloaded):
        srv.submit_insert(pts[:4])
    srv.shutdown()                                  # idempotent


def test_server_shutdown_without_drain_fails_pending():
    pts = pointclouds.load("blobs", 300, seed=8)
    srv = serve.Server(pts, [("t", EPS, MINPTS)], device="cpu",
                       config=serve.ServerConfig(max_batch=512,
                                                 max_delay_s=5.0))
    fut = srv.submit_query(pts[:8], tenant="t")     # parked on deadline
    srv.shutdown(drain=False)
    with pytest.raises(RuntimeError, match="without drain"):
        fut.result(timeout=10)
    assert srv.stats()["pending_requests"] == 0     # budget released
