"""The port's streaming index (``repro_torch.stream``) against the
reference's (``repro.stream``) on the CPU, zero tolerance.

The same op sequences (bootstrap, inserts that seal tiers and cascade,
deletes, expiry, merge and compact, queries of empty, inert and far
probes, snapshots with and without border points; blobs in 2-D and
boundary-separated points in 3-D) run through both packages; after every
op the
counts, core mask, labels and tombstones are byte-equal, and so are
the repair-sweep, merge, compaction and tier counters, every level's
gids, the ops' return values, the ``QueryResult`` fields and the
snapshots. Also here: the brute counts on boundary-grid data, the host helpers
against their numpy twins, a padded level's index, and ``freeze_view``
against the reference's.
The entry points (a cold start under a window, ``dbscan``'s ``stream``
backend, ``tenant_handles``, ``obs``) are in
``tests/test_torch_stream_api.py``.

Point sets are shared between cases: the reference compiles its walks
per level and probe shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

import jax  # noqa: E402
from repro.core import fdbscan as jfdbscan  # noqa: E402
from repro.core import unionfind as junionfind  # noqa: E402
from repro.stream import StreamingDBSCAN as JStream  # noqa: E402
from repro.stream import index as jindex  # noqa: E402

from repro_torch.core import fdbscan, unionfind  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.stream import StreamingDBSCAN  # noqa: E402
from repro_torch.stream import index as tindex  # noqa: E402

from conftest import separated_points  # noqa: E402

# the shared point sets: blobs in 2-D, boundary-separated uniform points in
# 3-D; inserts come in batches of BATCH
BLOBS = pointclouds.blobs(400, d=2, k=4, seed=1)
SEP3 = separated_points(300, 3, eps=0.2, seed=4)
MP_BLOBS, EPS_BLOBS = 6, 0.05
MP_SEP, EPS_SEP = 5, 0.2
BATCH = 24


def _port(*args, **kw):
    return StreamingDBSCAN(*args, device="cpu", **kw)


def _state(h, port: bool):
    host = (lambda x: x.numpy()) if port else np.asarray
    return {"counts": host(h._counts), "core": host(h._core),
            "labels": host(h._labels), "tombstone": host(h._tombstone),
            "levels": [np.asarray(host(lv.gids), np.int64)
                       for lv in h._levels()],
            "counters": (h.n_points, h.n_active, h.n_repair_sweeps,
                         h.n_compactions, h.n_merges, h.n_tiers,
                         h.n_inserts, h.n_deletes)}


def _assert_same_state(ref, port, what):
    a, b = _state(ref, False), _state(port, True)
    for key in ("counts", "core", "labels", "tombstone"):
        assert a[key].dtype == b[key].dtype, (what, key)
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"{what}: "
                                                              f"{key}")
    assert a["counters"] == b["counters"], what
    assert len(a["levels"]) == len(b["levels"]), what
    for x, y in zip(a["levels"], b["levels"]):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: level gids")


def _assert_same_query(ref, port, what):
    for name, x, y in zip(ref._fields, ref, port):
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")


def _assert_same_snapshot(ref, port, what):
    np.testing.assert_array_equal(np.asarray(ref.labels), port.labels.numpy(),
                                  err_msg=what)
    np.testing.assert_array_equal(np.asarray(ref.core_mask),
                                  port.core_mask.numpy(), err_msg=what)
    assert port.labels.dtype == torch.int32
    assert port.core_mask.dtype == torch.bool
    assert (port.n_clusters, port.n_sweeps, port.n_traversals,
            port.backend) == (ref.n_clusters, ref.n_sweeps,
                              ref.n_traversals, ref.backend), what


def _probes(pts, ref, rng, eps):
    """Inert probes (anywhere in the box, mostly empty space), far probes
    (outside it, on each padded level's sentinel coordinates) and resident
    points."""
    lo, hi = pts.min(0), pts.max(0)
    d = pts.shape[1]
    inert = rng.uniform(lo, hi, (24, d)).astype(np.float32)
    sent = [np.asarray(lv.segs.pts)[np.asarray(lv.gids) < 0][:1]
            for lv in ref._levels()]
    far = np.concatenate(sent + [(hi + 5.0)[None], (lo - 2 * eps)[None]])
    return np.concatenate([inert, far.astype(np.float32),
                           pts[rng.choice(len(pts), 36)]])


def _run_ops(pts, eps, mp, n_boot, ops, **kw):
    """Apply ``ops`` to a reference and a port handle; compare after
    every op. Ops: ("insert", i) the i-th batch after the bootstrap set,
    ("delete", frac) a seeded fraction of the active gids, ("expire", wm),
    ("merge",), ("compact",), ("query",), ("snapshot",)."""
    boot = pts[:n_boot] if n_boot else None
    ref = JStream(boot, eps, mp, **kw)
    port = _port(boot, eps, mp, **kw)
    _assert_same_state(ref, port, "bootstrap")
    rng = np.random.default_rng(0)
    nxt = n_boot
    for i, op in enumerate(ops):
        what = f"op {i} {op}"
        kind = op[0]
        if kind == "insert":
            batch = pts[nxt:nxt + BATCH]
            nxt += BATCH
            ref.insert(batch)
            port.insert(batch)
        elif kind == "delete":
            alive = ref.active_gids
            np.testing.assert_array_equal(alive, port.active_gids)
            gids = np.sort(rng.choice(alive, int(len(alive) * op[1]),
                                      replace=False))
            assert ref.delete(gids) == port.delete(gids) > 0, what
        elif kind == "expire":
            assert ref.expire(op[1]) == port.expire(op[1]), what
        elif kind in ("merge", "compact"):
            getattr(ref, kind)()
            getattr(port, kind)()
        elif kind == "query":
            probes = _probes(pts[:nxt], ref, rng, eps)
            _assert_same_query(ref.query(probes), port.query(probes), what)
            empty = np.zeros((0, pts.shape[1]), np.float32)
            _assert_same_query(ref.query(empty), port.query(empty), what)
        elif kind == "snapshot":
            for star in (False, True):
                _assert_same_snapshot(ref.snapshot(star=star),
                                      port.snapshot(star=star), what)
        _assert_same_state(ref, port, what)
        np.testing.assert_array_equal(ref.points, port.points)
    return ref, port


# bootstrap, inserts that seal a tier each (buffer_max < BATCH) and
# cascade (growth 2), deletes of a seeded share of the survivors, expiry,
# compact, merge, queries and snapshots; small sizes, so that the
# reference compiles few walk programs
OPS = [("insert",), ("insert",), ("delete", 0.15), ("snapshot",),
       ("query",), ("insert",), ("expire", 64), ("compact",),
       ("delete", 0.1), ("merge",), ("query",), ("snapshot",)]
# the same kinds of op, fewer of them, in 3-D
OPS_3D = [("insert",), ("insert",), ("delete", 0.15), ("query",),
          ("expire", 64), ("delete", 0.1), ("merge",), ("snapshot",)]
N_BOOT, BUFFER_MAX = 96, 20


@pytest.mark.parametrize("case", ["blobs_d2", "separated_d3"])
def test_op_sequence_matches_reference(case):
    if case == "blobs_d2":
        ref, port = _run_ops(BLOBS, EPS_BLOBS, MP_BLOBS, N_BOOT, OPS,
                             buffer_max=BUFFER_MAX, growth=2)
    else:
        ref, port = _run_ops(SEP3, EPS_SEP, MP_SEP, N_BOOT, OPS_3D,
                             buffer_max=BUFFER_MAX, growth=2)
    assert ref.n_compactions >= 4 and ref.n_merges == 1
    assert ref.n_repair_sweeps > 3 and ref.n_tombstoned > 0
    assert port.snapshot().n_clusters >= 2


def _boundary_grid(n, d, seed):
    """Points on a grid of step 0.1 with 1e-7 jitter: with eps = 0.3 many
    pairs lie at eps and the ulps around it (``chip_smoke.py``'s
    boundary-grid data)."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.integers(0, 12, (n, d))
            + rng.uniform(-1e-7, 1e-7, (n, d))).astype(np.float32)


@pytest.mark.parametrize("d", [2, 3])
def test_hits_blocked_matches_reference_on_boundary_grid(d):
    from repro_torch.core.lbvh import sum_sq
    a, b = _boundary_grid(300, d, 1), _boundary_grid(500, d, 2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    eps2 = np.float32(jax.numpy.asarray(0.3, jax.numpy.float32) ** 2)
    # and a radius on the rounding boundary of one pair of uniform points,
    # where the walk's fused rounding and the eager one disagree
    u = np.random.default_rng(d).uniform(0, 0.2, (400, d)).astype(np.float32)
    diff = torch.from_numpy(u[:, None, :] - u[None])
    eager, fused = tindex._dist2_eager(diff), sum_sq(diff)
    i, j = np.argwhere((eager != fused).numpy())[0]
    edge = np.float32(min(eager[i, j], fused[i, j]))
    for x, y, r2 in ((a, b, eps2), (u, u, edge)):
        want = jindex._hits_blocked(x, y, r2, block=64)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        t2 = torch.tensor(float(r2), dtype=torch.float32)
        for block in (64, 2048):
            got = tindex._hits_blocked(tx, ty, t2, block=block)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
    walk = (fused <= float(edge)).sum(1).numpy()
    assert (walk != want).any()     # the radius sits on a rounding edge


def test_host_helpers_match_numpy_twins():
    rng = np.random.default_rng(3)
    for d, pts in ((2, BLOBS), (3, SEP3)):
        eps = 0.05
        keys = jfdbscan._cell_keys(pts, eps)
        tkeys = fdbscan._cell_keys(torch.from_numpy(pts), eps)
        np.testing.assert_array_equal(tkeys.numpy(), keys)
        changed = rng.random(len(pts)) < 0.05
        np.testing.assert_array_equal(
            fdbscan._near_changed(tkeys, d, torch.from_numpy(changed))
            .numpy(), jfdbscan._near_changed(keys, d, changed))
    # a decreasing pointer forest (labels[i] <= i)
    n = 3000
    forest = np.array([rng.integers(0, i + 1) for i in range(n)], np.int32)
    np.testing.assert_array_equal(
        unionfind.jump_to_fixpoint(torch.from_numpy(forest)).numpy(),
        junionfind.jump_to_fixpoint_np(forest))
    # np.minimum.at -> scatter_reduce(amin), as the bootstrap uses it
    idx = rng.integers(0, 50, 400)
    src = rng.integers(0, 10_000, 400)
    want = np.full(50, 10_000, np.int64)
    np.minimum.at(want, idx, src)
    got = torch.full((50,), 10_000, dtype=torch.int64).scatter_reduce_(
        0, torch.from_numpy(idx), torch.from_numpy(src), "amin")
    np.testing.assert_array_equal(got.numpy(), want)
    for k in list(range(0, 300)) + [1023, 1024, 1025, 5000, 70_001]:
        assert fdbscan._pad_size(k) == jfdbscan._pad_size(k), k


@pytest.mark.parametrize("d", [2, 3])
def test_level_build_matches_reference(d):
    """A padded level (sentinels past the real points' box, Morton codes
    on the real points' bounds) is the same index in both packages."""
    pts = (BLOBS if d == 2 else SEP3)[:150]
    ref = JStream(None, 0.05, 5)
    port = _port(None, 0.05, 5)
    gids = np.arange(150, 300, dtype=np.int64)
    jl = ref._build_level(pts, gids)
    tl = port._build_level(torch.from_numpy(pts), torch.from_numpy(gids))
    assert len(tl.gids) == len(jl.gids) == fdbscan._pad_size(150)
    np.testing.assert_array_equal(tl.gids.numpy(), np.asarray(jl.gids))
    np.testing.assert_array_equal(tl.segs.pts.numpy(),
                                  np.asarray(jl.segs.pts))
    np.testing.assert_array_equal(tl.segs.codes.numpy(),
                                  np.asarray(jl.segs.codes, np.int64))
    for name in ("left", "right", "miss", "box_lo", "box_hi"):
        np.testing.assert_array_equal(getattr(tl.tree, name).numpy(),
                                      np.asarray(getattr(jl.tree, name)))
    assert tl.walk_index is None            # packed only on the card


def test_freeze_view_raises():
    """``freeze_view`` raised until the serving plane was ported (the
    name is kept); it now returns the reference's ``FrozenState``: the
    active points and int64 serving values, byte for byte, as copies."""
    ref, port = (make(BLOBS[:N_BOOT], EPS_BLOBS, MP_BLOBS)
                 for make in (JStream, _port))
    for h in (ref, port):
        h.delete(np.arange(0, N_BOOT, 5))
    a, b = ref.freeze_view(), port.freeze_view()
    assert type(b).__name__ == "FrozenState" and b._fields == a._fields
    for x, y in ((a.pts, b.pts), (a.vals, b.vals)):
        assert x.dtype == y.numpy().dtype
        np.testing.assert_array_equal(x, y.numpy())
    assert (b.watermark, b.n_tombstoned) == (a.watermark, a.n_tombstoned)
    assert type(b.watermark) is int and type(b.n_tombstoned) is int
    b.vals[:] = -5                          # a copy: the handle is intact
    assert (port.freeze_view().vals.numpy() == a.vals).all()
