"""Walk parity: the port's plain lane-vector engine against the JAX engine
(``repro.core.traversal.traverse``, the vmapped walk) and against the JAX
Pallas walk kernel (``repro.kernels.traverse.traverse``, interpret mode),
on one index fed to both packages through ``index_from_numpy``.

Tolerance: zero. ``acc``, ``hits`` and ``evals`` are byte-equal, and
``iters`` is byte-equal at the same ``unroll``: both sides take the same
steps with the same float32 roundings. The walk kernel itself
(``csrc/walk.cu``) performs these steps one thread per lane and is held
against this plain engine on the card by ``chip_smoke.py``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import grid as jgrid, lbvh as jlbvh  # noqa: E402
from repro.core import traversal as jtraversal  # noqa: E402
from repro.kernels import traverse as jkt  # noqa: E402

from repro_torch.convert import index_from_numpy  # noqa: E402
from repro_torch.core import traversal  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.kernels import traverse as kt, walkpack  # noqa: E402

INT_MAX = 2**31 - 1
CPU = torch.device("cpu")
# (dataset, n, eps, min_pts): a 2-D densebox index with dense cells, and
# a 3-D one
INDEXES = {"porto2d": ("portotaxi_like", 480, 0.05, 8),
           "hacc3d": ("hacc_like", 400, 0.08, 5)}


def _index(key):
    dset, n, eps, mp = INDEXES[key]
    pts = jnp.asarray(pointclouds.load(dset, n))
    jsegs = jgrid.build_segments_densebox(pts, eps, mp)
    jtree = jlbvh.build_tree(jsegs.codes, jsegs.prim_lo, jsegs.prim_hi)
    segs, tree = index_from_numpy(
        {f: np.asarray(getattr(jsegs, f)) for f in jsegs._fields},
        {f: np.asarray(getattr(jtree, f)) for f in jtree._fields}, CPU)
    return (jsegs, jtree), (segs, tree), eps, mp


@pytest.fixture(scope="module")
def indexes():
    return {k: _index(k) for k in INDEXES}


def _case(name, segs, eps, mp):
    """numpy inputs of one walk: (pred, visitor, kwargs) as dicts of
    plain arrays, built once and handed to both packages."""
    n = segs.n_points
    m = segs.n_segments
    rng = np.random.default_rng(CASES.index(name))
    vals = np.arange(n, dtype=np.int32)
    if name == "count":
        return dict(kind="count", cap=mp), {}, {}
    if name == "count_range_mask":
        return dict(kind="count", cap=INT_MAX), {}, {"use_range_mask": True}
    if name == "countminlabel":
        return (dict(kind="countminlabel", vals=vals,
                     mask=np.ones(n, bool), cap=mp - 1), {}, {})
    if name == "minlabel_node_mask_compacted":
        ids = np.full(256, -1, np.int32)
        ids[:200] = np.sort(rng.choice(n, 200, replace=False))
        return (dict(kind="minlabel", vals=vals, mask=rng.random(n) < 0.5),
                {"ids": ids},
                {"leaf_flags": np.arange(m) % 3 != 0})
    if name == "minlabel_dual_wide":
        return (dict(kind="minlabel", vals=vals, mask=np.arange(n) % 4 == 0,
                     mask_wide=np.ones(n, bool)), {},
                {"leaf_flags": np.arange(m) % 2 == 0, "wide_all_nodes": True,
                 "wide_lanes": np.arange(n) % 5 == 0})
    if name == "minlabel_float_vals":
        return (dict(kind="minlabel",
                     vals=rng.uniform(0, 1, n).astype(np.float32),
                     mask=np.ones(n, bool)), {}, {})
    if name == "external_seeded_carry":
        d = segs.pts.shape[1]
        return (dict(kind="minlabel", vals=vals, mask=np.ones(n, bool)),
                {"pts": rng.uniform(0, 1, (137, d)).astype(np.float32),
                 "r_scale": 3.0}, {"chain": True})
    raise KeyError(name)


CASES = ["count", "count_range_mask", "countminlabel",
         "minlabel_node_mask_compacted", "minlabel_dual_wide",
         "minlabel_float_vals", "external_seeded_carry"]


def _build(ns, cb, pred, kw, segs, tree, eps, propagate):
    """The walk's arguments in one package's types (``ns`` is the
    traversal module, ``arr`` its array constructor)."""
    if ns is jtraversal:
        arr = jnp.asarray
    else:
        def arr(x):
            return torch.from_numpy(np.ascontiguousarray(x))
    if cb["kind"] == "count":
        visitor = ns.CountVisitor(cap=cb["cap"])
    elif cb["kind"] == "countminlabel":
        visitor = ns.CountMinLabelVisitor(arr(cb["vals"]), arr(cb["mask"]),
                                          cap=cb["cap"])
    else:
        visitor = ns.MinLabelVisitor(
            arr(cb["vals"]), arr(cb["mask"]),
            None if "mask_wide" not in cb else arr(cb["mask_wide"]))
    r = eps * pred.get("r_scale", 1.0)
    predicate = ns.intersects(
        ns.sphere(r), ids=None if "ids" not in pred else arr(pred["ids"]),
        pts=None if "pts" not in pred else arr(pred["pts"]))
    out = {}
    if "use_range_mask" in kw:
        out["use_range_mask"] = True
    if "leaf_flags" in kw:
        out["node_mask"] = propagate(tree, arr(kw["leaf_flags"]))
    if kw.get("wide_all_nodes"):
        out["node_mask_wide"] = arr(np.ones(2 * segs.n_segments - 1, bool))
        out["wide_lanes"] = arr(kw["wide_lanes"])
    return predicate, visitor, out


def _assert_trace_equal(ref, port, iters_too):
    np.testing.assert_array_equal(np.asarray(ref.acc), port.acc.numpy())
    np.testing.assert_array_equal(np.asarray(ref.hits), port.hits.numpy())
    np.testing.assert_array_equal(np.asarray(ref.evals), port.evals.numpy())
    if iters_too:
        np.testing.assert_array_equal(np.asarray(ref.iters),
                                      port.iters.numpy())
    assert port.evals.dtype == port.iters.dtype == torch.int32


def _run_pair(indexes, key, name, ref_walk, unroll):
    (jsegs, jtree), (segs, tree), eps, mp = indexes[key]
    cb, pred, kw = _case(name, segs, eps, mp)
    jp, jv, jkw = _build(jtraversal, cb, pred, kw, jsegs, jtree, eps,
                         jlbvh.propagate_leaf_flags)
    from repro_torch.core import lbvh
    tp, tv, tkw = _build(traversal, cb, pred, kw, segs, tree, eps,
                         lbvh.propagate_leaf_flags)
    ref = ref_walk(jtree, jsegs, jp, jv, unroll=unroll, **jkw)
    port = traversal.traverse(tree, segs, tp, tv, unroll=unroll, **tkw)
    _assert_trace_equal(ref, port, iters_too=True)
    if kw.get("chain"):         # seed a second walk with the first's carry
        ref2 = ref_walk(jtree, jsegs, jp, jv, carry=ref.carry,
                        unroll=unroll, **jkw)
        port2 = traversal.traverse(tree, segs, tp, tv, carry=port.carry,
                                   unroll=unroll, **tkw)
        _assert_trace_equal(ref2, port2, iters_too=True)


@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("name", CASES)
def test_plain_engine_matches_jax_engine(indexes, name, unroll):
    _run_pair(indexes, "porto2d", name, jtraversal.traverse, unroll)


@pytest.mark.parametrize("name", CASES)
def test_plain_engine_matches_pallas_walk(indexes, name):
    # the Pallas kernel in interpret mode at its own default unroll (4)
    _run_pair(indexes, "porto2d", name, jkt.traverse, 4)


@pytest.mark.parametrize("name", ["count", "countminlabel",
                                  "minlabel_dual_wide"])
def test_plain_engine_matches_pallas_walk_3d_unroll1(indexes, name):
    _run_pair(indexes, "hacc3d", name, jkt.traverse, 1)


def test_wrapper_runs_plain_engine_for_cpu_tensors(indexes):
    (_, _), (segs, tree), eps, mp = indexes["porto2d"]
    pred = traversal.intersects(traversal.sphere(eps))
    cb = traversal.CountVisitor(cap=mp)
    runs, launches = traversal.traverse.runs, kt.walk.launches
    a = kt.traverse(tree, segs, pred, cb)
    b = traversal.traverse(tree, segs, pred, cb,
                           unroll=traversal.DEFAULT_UNROLL)
    _assert_trace_equal(a, b, iters_too=True)
    assert traversal.traverse.runs == runs + 2
    assert kt.walk.launches == launches        # the kernel never ran


def test_kernel_entry_refuses_cpu_tensors(indexes):
    # the launch function takes CUDA tensors only: no quiet CPU path
    (_, _), (segs, tree), eps, _ = indexes["porto2d"]
    n = segs.n_points
    z = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kt.walk(0, q=segs.pts, qid=z, self_id=z,
                dense=torch.zeros(n, dtype=torch.bool), rank=z,
                wide=torch.zeros(n, dtype=torch.bool), acc0=z, hits0=z,
                index=walkpack.pack_index(tree, segs),
                r2=traversal.radius2(eps))


def test_fusible_matches_reference_rules():
    pred = traversal.intersects(traversal.sphere(0.1))
    v = torch.zeros(3, dtype=torch.int32)
    m = torch.ones(3, dtype=torch.bool)
    for cb in (traversal.CountVisitor(), traversal.MinLabelVisitor(v, m),
               traversal.CountMinLabelVisitor(v, m)):
        assert kt.fusible(pred, cb)

    class Custom(traversal.MinLabelVisitor):
        pass

    assert not kt.fusible(pred, Custom(v, m))
    assert kt.PALLAS_UNROLL == jkt.PALLAS_UNROLL
    assert traversal.radius2(0.1) == float(np.float32(0.1) * np.float32(0.1))


@pytest.mark.parametrize("d", [2, 3])
def test_boundary_pairs_match_jax_walks(d):
    # points on a coarse grid put many pairs (and boxes) at the eps
    # boundary, within an ulp: the walks agree only where every squared
    # distance rounds identically (x0*x0, then one fused multiply-add per
    # axis, as the reference's compiled walk rounds it)
    rng = np.random.default_rng(d)
    pts = (rng.integers(0, 12, (400, d)) * np.float32(0.1)
           + rng.uniform(-1e-7, 1e-7, (400, d))).astype(np.float32)
    eps = 0.3
    jsegs = jgrid.build_segments_fdbscan(jnp.asarray(pts))
    jtree = jlbvh.build_tree(jsegs.codes, jsegs.prim_lo, jsegs.prim_hi)
    segs, tree = index_from_numpy(
        {f: np.asarray(getattr(jsegs, f)) for f in jsegs._fields},
        {f: np.asarray(getattr(jtree, f)) for f in jtree._fields}, CPU)
    port = traversal.traverse(tree, segs,
                              traversal.intersects(traversal.sphere(eps)),
                              traversal.CountVisitor(), unroll=4)
    jpred = jtraversal.intersects(jtraversal.sphere(eps))
    for walk in (jtraversal.traverse, jkt.traverse):
        ref = walk(jtree, jsegs, jpred, jtraversal.CountVisitor(), unroll=4)
        _assert_trace_equal(ref, port, iters_too=True)


def test_index_from_numpy_round_trip(indexes):
    (jsegs, jtree), (segs, tree), _, _ = indexes["hacc3d"]
    assert segs.codes.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(jsegs.codes).astype(np.int64),
                                  segs.codes.numpy())
    for f in jtree._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jtree, f)),
                                      getattr(tree, f).numpy())
    s2, t2 = index_from_numpy({f: np.asarray(getattr(jsegs, f))
                               for f in jsegs._fields}, None, CPU)
    assert t2 is None and s2.n_segments == segs.n_segments
    with pytest.raises(TypeError):
        index_from_numpy({**{f: np.asarray(getattr(jsegs, f))
                             for f in jsegs._fields},
                          "pts": np.zeros((3, 3), np.float16)}, None, CPU)


# --------------------------------------------------------------------- #
# the reference's public helpers over the walk (its traversal.py names)  #
# --------------------------------------------------------------------- #

def _helper_inputs(segs, seed):
    """numpy labels, gather mask and active-query mask for the helpers."""
    n = segs.n_points
    rng = np.random.default_rng(seed)
    labels = rng.permutation(n).astype(np.int32)
    return labels, rng.random(n) < 0.6, rng.random(n) < 0.7


@pytest.mark.parametrize("key", sorted(INDEXES))
def test_helpers_match_reference(indexes, key):
    # count_neighbors(_with_work), minlabel_sweep, fused_count_minlabel and
    # border_gather with the reference's signatures, byte-equal (results,
    # hits, evals; the fused pass's iters at the same unroll) on one index
    (jsegs, jtree), (segs, tree), eps, mp = indexes[key]
    labels, gather, active = _helper_inputs(segs, 7)
    t = torch.from_numpy
    jl, jg, ja = jnp.asarray(labels), jnp.asarray(gather), jnp.asarray(active)
    for cap, qa in ((mp, None), (INT_MAX, active)):
        want, wev = jtraversal.count_neighbors_with_work(
            jtree, jsegs, eps, cap, None if qa is None else ja)
        got, gev = traversal.count_neighbors_with_work(
            tree, segs, eps, cap, None if qa is None else t(qa))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        np.testing.assert_array_equal(np.asarray(wev), gev.numpy())
        np.testing.assert_array_equal(
            np.asarray(jtraversal.count_neighbors(jtree, jsegs, eps, cap)),
            traversal.count_neighbors(tree, segs, eps, cap).numpy())
    for fn in ("minlabel_sweep", "border_gather"):
        want = getattr(jtraversal, fn)(jtree, jsegs, eps, jl, jg, ja)
        got = getattr(traversal, fn)(tree, segs, eps, t(labels), t(gather),
                                     t(active))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    ids = np.where(active, np.arange(segs.n_points), -1).astype(np.int32)
    want = jtraversal.fused_count_minlabel(
        jtree, jsegs, eps, jl, jg, jnp.asarray(ids), cap=mp - 1)
    got = traversal.fused_count_minlabel(tree, segs, eps, t(labels),
                                         t(gather), t(ids), cap=mp - 1)
    _assert_trace_equal(want, got, iters_too=True)
    # through the walk entry at the kernel's unroll, lanes in depth order
    want = jtraversal.fused_count_minlabel(
        jtree, jsegs, eps, jl, traverse_fn=jkt.traverse,
        depth_rank=jnp.asarray(labels))
    got = traversal.fused_count_minlabel(
        tree, segs, eps, t(labels),
        traverse_fn=lambda *a, **k: kt.traverse(*a, unroll=4, reorder="depth",
                                                **k),
        depth_rank=t(labels))
    _assert_trace_equal(want, got, iters_too=True)


def test_tree_and_unionfind_names_match_reference(indexes):
    from repro.core import unionfind as junionfind
    from repro_torch.core import unionfind
    (jsegs, jtree), (segs, tree), _, _ = indexes["hacc3d"]
    assert tree.n_leaves == jtree.n_leaves == segs.n_segments
    assert tree.leaf_id(3) == jtree.leaf_id(3)
    node = np.array([-5, 0, 3, tree.n_leaves - 2, 10**6], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jtraversal.tree_left(jtree, jnp.asarray(node))),
        traversal.tree_left(tree, torch.from_numpy(node)).numpy())
    rng = np.random.default_rng(2)
    forest = np.array([rng.integers(0, i + 1) for i in range(300)], np.int64)
    np.testing.assert_array_equal(junionfind.jump_to_fixpoint_np(forest),
                                  unionfind.jump_to_fixpoint_np(forest))
    assert kt.LANE_TILE == jkt.LANE_TILE == 128
    assert [c.__name__ for c in kt.FUSIBLE_VISITORS] == [
        c.__name__ for c in jkt.FUSIBLE_VISITORS]


GOLDEN = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "golden", "golden.npz"))
# (dataset, n, eps, min_pts) — the scenarios of tests/golden/make_golden.py
GOLDEN_SCENARIOS = [
    ("ngsim_like", 800, 0.01, 5),
    ("portotaxi_like", 800, 0.02, 5),
    ("road3d_like", 800, 0.01, 5),
    ("hacc_like", 800, 0.05, 5),
    ("blobs", 800, 0.05, 8),
]


@pytest.mark.parametrize("case", GOLDEN_SCENARIOS,
                         ids=[c[0] for c in GOLDEN_SCENARIOS])
def test_golden_counts(case):
    # exact uncapped neighbor counts over the plain fdbscan plan, in the
    # original point order (the reference's tests/test_golden.py case)
    from repro_torch.core import dispatch
    dset, n, eps, mp = case
    p = dispatch.plan(pointclouds.load(dset, n), eps, mp,
                      algorithm="fdbscan", device=CPU)
    counts = np.zeros(n, np.int64)
    counts[p.segs.order.numpy()] = traversal.count_neighbors(
        p.tree, p.segs, eps, cap=INT_MAX).numpy()
    np.testing.assert_array_equal(counts, GOLDEN[f"{dset}/counts"])


@pytest.mark.parametrize("case", GOLDEN_SCENARIOS,
                         ids=[c[0] for c in GOLDEN_SCENARIOS])
def test_golden_stream(case):
    # bootstrap with 5/8 of the points, two inserts, a merge, a snapshot:
    # the reference's tests/test_golden.py stream case
    import repro_torch
    dset, n, eps, mp = case
    pts = pointclouds.load(dset, n)
    cut = n * 5 // 8
    h = repro_torch.stream_handle(pts[:cut], eps, mp, device=CPU)
    h.insert(pts[cut:cut + (n - cut) // 2])
    h.insert(pts[cut + (n - cut) // 2:])
    h.merge()
    res = h.snapshot()
    np.testing.assert_array_equal(res.labels.numpy(),
                                  GOLDEN[f"{dset}/stream/labels"])
    np.testing.assert_array_equal(res.core_mask.numpy(),
                                  GOLDEN[f"{dset}/stream/core"])
    assert res.n_clusters == int(GOLDEN[f"{dset}/stream/n_clusters"])
