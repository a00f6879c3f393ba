"""Lane reordering in the port (``traversal.lane_sort_key`` and
``kernels.traverse.traverse(reorder=, depth_rank=, lane_tile=)``) against
the reference's: the sort keys equal, and the walk under every policy
equal to the reference's Pallas walk (``repro.kernels.traverse``,
interpret mode) for the three kernel visitors on resident, compacted
(with dead lanes and a node mask) and external batches. On the CPU the
walk entry runs the plain engine over the permuted lanes and puts the
outputs back in lane order, so these cases cover the permutation code the
walk kernel's launch shares. The end-to-end half runs the tuned pipeline
(heuristic: depth order, calibrated on the second run) against the golden
file.

Tolerance: zero. ``acc``, ``hits`` and ``evals`` are byte-equal under
every policy, ``iters`` at the same unroll; sort keys are equal as
integers (the port keeps them int64: the reference's depth keys are int32,
its Morton keys uint32).
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
from repro_torch.core import dispatch, lbvh, traversal  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.kernels import traverse as kt  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = np.load(os.path.join(HERE, "golden", "golden.npz"))
CPU = torch.device("cpu")
INT_MAX = 2**31 - 1

# the reference's tests/test_reorder.py point sets (n = 300): a 3-D and a
# 2-D scenario, each with its eps and min_pts
SCENARIOS = {"hacc_like": (0.08, 5), "portotaxi_like": (0.04, 5)}
N = 300
# tests/golden/make_golden.py's scenarios
GOLDEN_SCENARIOS = [
    ("ngsim_like", 800, 0.01, 5),
    ("portotaxi_like", 800, 0.02, 5),
    ("road3d_like", 800, 0.01, 5),
    ("hacc_like", 800, 0.05, 5),
    ("blobs", 800, 0.05, 8),
]
VISITORS = ["count", "minlabel", "countminlabel"]
BATCHES = ["resident", "compacted", "external"]
POLICIES = ["none", "morton", "depth"]


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def case(request):
    """One index in both packages (the reference's, converted), its eps
    and min_pts, and the depth oracle as the tuner calibrates it (per-query
    trips of a full count pass, by sorted id) in both packages."""
    dset = request.param
    eps, mp = SCENARIOS[dset]
    pts = jnp.asarray(pointclouds.load(dset, N))
    jsegs = jgrid.build_segments_fdbscan(pts)
    jtree = jlbvh.build_tree(jsegs.codes, jsegs.prim_lo, jsegs.prim_hi)
    segs, tree = index_from_numpy(
        {f: np.asarray(getattr(jsegs, f)) for f in jsegs._fields},
        {f: np.asarray(getattr(jtree, f)) for f in jtree._fields}, CPU)
    jrank = jtraversal.traverse(
        jtree, jsegs, jtraversal.intersects(jtraversal.sphere(eps)),
        jtraversal.CountVisitor(cap=jtraversal.INT_MAX)).iters
    rank = torch.from_numpy(np.asarray(jrank).copy())
    return (jsegs, jtree, jrank), (segs, tree, rank), eps, mp


def _inputs(batch, n, m, d, eps):
    """numpy inputs of one batch shape: (ids, external points, leaf flags
    of the node mask, radius)."""
    rng = np.random.default_rng(3)
    if batch == "resident":
        return None, None, None, eps
    if batch == "compacted":
        ids = np.full(192, -1, np.int32)
        ids[:160] = rng.choice(n, 160, replace=False)
        return ids, None, np.arange(m) % 3 != 0, eps
    qpts = rng.uniform(0, 1, (117, d)).astype(np.float32)
    return None, qpts, None, 2 * eps


def _walk_args(pkg, batch, visitor, segs, tree, eps, mp):
    """(predicate, visitor, kwargs) of one case for one package."""
    tr = jtraversal if pkg == "ref" else traversal
    arr = jnp.asarray if pkg == "ref" else torch.from_numpy
    n, m, d = segs.pts.shape[0], segs.seg_start.shape[0], segs.pts.shape[1]
    ids, qpts, flags, r = _inputs(batch, n, m, d, eps)
    pred = tr.intersects(tr.sphere(r), ids=None if ids is None else arr(ids),
                         pts=None if qpts is None else arr(qpts))
    kw = {}
    if flags is not None:
        prop = jlbvh.propagate_leaf_flags if pkg == "ref" \
            else lbvh.propagate_leaf_flags
        kw["node_mask"] = prop(tree, arr(flags))
    vals = arr(np.arange(n, dtype=np.int32))
    mask = arr(np.arange(n) % 2 == 0)
    if visitor == "count":
        cb = tr.CountVisitor(cap=mp)
    elif visitor == "minlabel":
        cb = tr.MinLabelVisitor(vals, mask)
    else:
        cb = tr.CountMinLabelVisitor(vals, mask, cap=mp - 1)
    return pred, cb, kw


def _assert_equal(ref, port, iters_too=True):
    np.testing.assert_array_equal(np.asarray(ref.acc), port.acc.numpy())
    np.testing.assert_array_equal(np.asarray(ref.hits), port.hits.numpy())
    np.testing.assert_array_equal(np.asarray(ref.evals), port.evals.numpy())
    if iters_too:
        np.testing.assert_array_equal(np.asarray(ref.iters),
                                      port.iters.numpy())


@pytest.mark.parametrize("batch", BATCHES)
def test_lane_sort_key_matches_reference(case, batch):
    # every policy, dead lanes included (the compacted batch's -1 tail)
    (jsegs, jtree, jrank), (segs, tree, rank), eps, mp = case
    jpred, _, _ = _walk_args("ref", batch, "count", jsegs, jtree, eps, mp)
    pred, _, _ = _walk_args("port", batch, "count", segs, tree, eps, mp)
    jl = jtraversal.lane_arrays(jsegs, jpred)
    pl = traversal.lane_arrays(segs, pred)
    for policy in POLICIES:
        for with_rank in (False, True):
            want = jtraversal.lane_sort_key(policy, jl[0], jl[1], jl[5],
                                            jrank if with_rank else None)
            got = traversal.lane_sort_key(policy, pl[0], pl[1], pl[5],
                                          rank if with_rank else None)
            if want is None:
                assert got is None, (policy, with_rank)
                continue
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(
                np.asarray(want).astype(np.int64), got.numpy())
    if batch == "compacted":
        dead = pl[0] < 0
        assert int(traversal.lane_sort_key(
            "morton", pl[0], pl[1], False)[dead].min()) == 0xFFFFFFFF
        assert int(traversal.lane_sort_key(
            "depth", pl[0], pl[1], False, rank)[dead].min()) == INT_MAX
    with pytest.raises(ValueError, match="reorder"):
        traversal.lane_sort_key("zorder", pl[0], pl[1], pl[5])


@pytest.mark.parametrize("visitor", VISITORS)
@pytest.mark.parametrize("batch", BATCHES)
def test_walk_under_every_policy_matches_reference(case, batch, visitor):
    # the reference's Pallas walk (interpret mode, unroll 4, reordered by
    # depth) against the port's walk entry under every policy at the same
    # unroll, each at another lane tile (the plain engine has no blocks):
    # per-lane acc, hits, evals and iters equal
    (jsegs, jtree, jrank), (segs, tree, rank), eps, mp = case
    jpred, jcb, jkw = _walk_args("ref", batch, visitor, jsegs, jtree, eps,
                                 mp)
    ref = jkt.traverse(jtree, jsegs, jpred, jcb, reorder="depth",
                       depth_rank=jrank, **jkw)
    pred, cb, kw = _walk_args("port", batch, visitor, segs, tree, eps, mp)
    for policy, lane_tile in zip(POLICIES, (64, 256, 512)):
        port = kt.traverse(tree, segs, pred, cb, unroll=4,
                           lane_tile=lane_tile, reorder=policy,
                           depth_rank=rank, **kw)
        _assert_equal(ref, port)


def test_depth_without_rank_is_identity_for_resident(case):
    # uncalibrated depth order (a plan's first run): resident batches keep
    # lane order, external batches fall back to Morton — both exact
    _, (segs, tree, rank), eps, mp = case
    for batch in ("resident", "external"):
        pred, cb, kw = _walk_args("port", batch, "count", segs, tree, eps,
                                  mp)
        plain = traversal.traverse(tree, segs, pred, cb, **kw)
        port = kt.traverse(tree, segs, pred, cb, reorder="depth",
                           depth_rank=None, **kw)
        _assert_equal(plain, port)


@pytest.mark.parametrize("policy", POLICIES)
def test_query_permutation_composes(case, policy):
    # permuting the lane batch commutes with the reorder: lane i of the
    # output always belongs to query i of the (permuted) batch
    _, (segs, tree, rank), eps, mp = case
    rng = np.random.default_rng(11)
    live = rng.choice(N, 160, replace=False).astype(np.int32)
    cb = traversal.MinLabelVisitor(torch.arange(N, dtype=torch.int32),
                                   torch.from_numpy(np.arange(N) % 2 == 0))
    ref = traversal.traverse(
        tree, segs, traversal.intersects(traversal.sphere(eps),
                                         ids=torch.from_numpy(live)), cb)
    for _ in range(2):
        perm = rng.permutation(live.shape[0])
        port = kt.traverse(
            tree, segs,
            traversal.intersects(traversal.sphere(eps),
                                 ids=torch.from_numpy(live[perm])),
            cb, reorder=policy, depth_rank=rank)
        for a, b in ((port.acc, ref.acc), (port.hits, ref.hits),
                     (port.evals, ref.evals), (port.iters, ref.iters)):
            np.testing.assert_array_equal(a.numpy(), b.numpy()[perm])


def test_external_permutation_and_seeded_carry_compose(case):
    # the same law for external batches (the Morton key), with a carry
    # seeded by a first walk and wide lanes permuted with their lanes
    _, (segs, tree, rank), eps, mp = case
    d = segs.pts.shape[1]
    rng = np.random.default_rng(5)
    qpts = torch.from_numpy(rng.uniform(0, 1, (117, d)).astype(np.float32))
    cb = traversal.MinLabelVisitor(torch.arange(N, dtype=torch.int32),
                                   torch.from_numpy(np.arange(N) % 3 == 0),
                                   mask_wide=torch.ones(N, dtype=torch.bool))
    pred = traversal.intersects(traversal.sphere(2 * eps), pts=qpts)
    wide = torch.from_numpy(rng.random(117) < 0.5)
    first = traversal.traverse(tree, segs, pred, cb)
    ref = traversal.traverse(tree, segs, pred, cb, carry=first.carry,
                             wide_lanes=wide)
    port = kt.traverse(tree, segs, pred, cb, carry=first.carry,
                       wide_lanes=wide, reorder="morton")
    _assert_equal(ref, port)


def test_bad_policy_rejected(case):
    _, (segs, tree, _), eps, mp = case
    with pytest.raises(ValueError, match="reorder"):
        kt.traverse(tree, segs, traversal.intersects(traversal.sphere(eps)),
                    traversal.CountVisitor(cap=mp), reorder="zorder")


@pytest.mark.parametrize("dset", [c[0] for c in GOLDEN_SCENARIOS])
def test_e2e_tuned_reorder_golden(dset, monkeypatch):
    # heuristic mode: depth order, the small-frontier fallback; the same
    # plan twice, so the uncalibrated first run and the calibrated second
    # run (depth oracle live, indexed by compacted sweep and border lanes)
    # are both held against the goldens
    monkeypatch.setenv("REPRO_TUNE", "heuristic")
    dset, n, eps, mp = next(c for c in GOLDEN_SCENARIOS if c[0] == dset)
    pts = pointclouds.load(dset, n)
    dispatch.clear_cache()
    try:
        p = dispatch.plan(pts, eps, mp, algorithm="pallas-tree",
                          device="cpu")
        assert p.tune.config.source == "heuristic"
        assert p.stats["tuned_config"]["source"] == "heuristic"
        for _ in range(2):
            res = dispatch.dbscan(pts, eps, mp, query_plan=p)
            g = f"{dset}/fdbscan"
            np.testing.assert_array_equal(res.labels.numpy(),
                                          GOLDEN[f"{g}/labels"])
            np.testing.assert_array_equal(res.core_mask.numpy(),
                                          GOLDEN[f"{g}/core"])
            assert res.n_clusters == int(GOLDEN[f"{g}/n_clusters"])
            assert res.n_sweeps == int(GOLDEN[f"{g}/n_sweeps"])
        assert p.tune.depth_rank is not None        # calibration happened
    finally:
        dispatch.clear_cache()
