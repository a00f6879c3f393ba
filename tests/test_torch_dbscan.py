"""End to end: ``repro_torch.dbscan`` on the CPU (the plain versions of
every kernel) against the golden file and against live ``repro.dbscan``.

Tolerance: zero. Labels, core masks, ``n_clusters``, ``n_sweeps`` and
``n_traversals`` are byte-equal; so are the per-sweep work counters of
the tree backends (both packages walk with one work unit per trip on the
CPU).
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

import repro  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import fdbscan as jfdbscan  # noqa: E402
from repro.core.validate import check_dbscan  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import dispatch, fdbscan  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402

from conftest import separated_points  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = np.load(os.path.join(HERE, "golden", "golden.npz"))
# (dataset, n, eps, min_pts) — the scenarios of tests/golden/make_golden.py
SCENARIOS = [
    ("ngsim_like", 800, 0.01, 5),
    ("portotaxi_like", 800, 0.02, 5),
    ("road3d_like", 800, 0.01, 5),
    ("hacc_like", 800, 0.05, 5),
    ("blobs", 800, 0.05, 8),
]


def _run(pts, eps, mp, **kw):
    return repro_torch.dbscan(pts, eps, mp, device="cpu", **kw)


def _assert_same(ref, res, sweeps=True):
    np.testing.assert_array_equal(np.asarray(ref.labels), res.labels.numpy())
    np.testing.assert_array_equal(np.asarray(ref.core_mask),
                                  res.core_mask.numpy())
    assert res.labels.dtype == torch.int32
    assert res.core_mask.dtype == torch.bool
    assert res.n_clusters == ref.n_clusters
    if sweeps:
        assert (res.n_sweeps, res.n_traversals) == (ref.n_sweeps,
                                                   ref.n_traversals)


@pytest.mark.parametrize("algorithm", ["fdbscan", "fdbscan-densebox",
                                       "tiled", "pallas-tree", "auto"])
@pytest.mark.parametrize("dset", [c[0] for c in SCENARIOS])
def test_golden_byte_equal(dset, algorithm):
    _, n, eps, mp = next(c for c in SCENARIOS if c[0] == dset)
    res = _run(pointclouds.load(dset, n), eps, mp, algorithm=algorithm)
    # pallas-tree walks the plain fdbscan index; auto picks the tiles at
    # this n (<= TILED_MAX_POINTS)
    golden = {"pallas-tree": "fdbscan", "auto": "tiled"}.get(algorithm,
                                                             algorithm)
    assert res.backend == golden if algorithm != "pallas-tree" \
        else res.backend == "pallas-tree"
    g = f"{dset}/{golden}"
    np.testing.assert_array_equal(res.labels.numpy(), GOLDEN[f"{g}/labels"])
    np.testing.assert_array_equal(res.core_mask.numpy(), GOLDEN[f"{g}/core"])
    assert res.n_clusters == int(GOLDEN[f"{g}/n_clusters"])
    if golden != "tiled":
        assert res.n_sweeps == int(GOLDEN[f"{g}/n_sweeps"])
        assert res.n_traversals == res.n_sweeps + 1
    else:
        assert (res.n_sweeps, res.n_traversals) == (-1, 0)


LIVE = [("separated2d", 1500, 0.06, 6), ("hacc_like", 1200, 0.06, 5)]


def _live_points(name, n):
    if name == "separated2d":
        return separated_points(n, 2, eps=0.06, seed=1)
    return pointclouds.load(name, n, seed=7)


@pytest.mark.parametrize("case", LIVE, ids=[c[0] for c in LIVE])
def test_auto_matches_live_reference(case):
    name, n, eps, mp = case
    pts = _live_points(name, n)
    ref = repro.dbscan(pts, eps, mp)
    res = _run(pts, eps, mp)
    assert res.backend == ref.backend        # the same auto decision
    _assert_same(ref, res)


@pytest.mark.parametrize("algorithm,frontier", [("fdbscan-densebox", True)])
def test_sweep_work_counters_match_reference(algorithm, frontier):
    # per-sweep frontier sizes, active lanes, loop trips and distance
    # evaluations: the walks of every phase take the reference's steps
    dset, n, eps, mp = SCENARIOS[1]
    pts = pointclouds.load(dset, n)
    jp = jdispatch.plan(pts, eps, mp, algorithm=algorithm)
    ref, ref_stats = jfdbscan.cluster_from_index(
        jp.segs, jp.tree, eps, mp, frontier=frontier, backend=algorithm,
        with_stats=True)
    p = dispatch.plan(pts, eps, mp, algorithm=algorithm, device="cpu")
    res, stats = fdbscan.cluster_from_index(
        p.segs, p.tree, eps, mp, frontier=frontier, backend=algorithm,
        with_stats=True)
    _assert_same(ref, res)
    assert stats == ref_stats


@pytest.mark.parametrize("algorithm", ["fdbscan-densebox", "tiled"])
def test_star_and_full_sweeps_match_reference(algorithm):
    # the scenario of the counter test above: the reference reuses its
    # compiled walks
    dset, n, eps, mp = SCENARIOS[1]
    pts = pointclouds.load(dset, n)
    for kw in ({"star": True}, {"frontier": False}):
        if algorithm == "tiled" and "frontier" in kw:
            with pytest.raises(ValueError, match="frontier"):
                _run(pts, eps, mp, algorithm=algorithm, **kw)
            continue
        ref = repro.dbscan(pts, eps, mp, algorithm=algorithm, **kw)
        res = _run(pts, eps, mp, algorithm=algorithm, **kw)
        _assert_same(ref, res)
        if kw.get("star"):
            assert (res.labels[~res.core_mask] == -1).all()


def _degenerate_cases():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (60, 2)).astype(np.float32)
    one = pts[:1]
    dup = np.tile(pts[:1], (20, 1))
    # two tight groups, every point core: the border gather has no lanes
    two = np.concatenate([rng.uniform(0, 0.01, (20, 2)),
                          rng.uniform(0.5, 0.51, (20, 2))]).astype(np.float32)
    # (name, points, eps, min_pts, expected clusters: 0 = all noise)
    return [
        ("minpts_gt_n", pts, 0.1, len(pts) + 40, 0),
        ("eps_gt_bbox", pts, 50.0, 5, 1),
        ("n1_minpts1", one, 0.1, 1, 1),
        ("n1_minpts2", one, 0.1, 2, 0),
        ("all_dup", dup, 0.1, 5, 1),
        ("all_dup_minpts_gt_n", dup, 0.1, len(dup) + 1, 0),
        ("eps_zero", pts, 0.0, 1, 60),
        ("all_core_two_groups", two, 0.1, 5, 2),
    ]


@pytest.mark.parametrize("algorithm", ["fdbscan", "fdbscan-densebox",
                                       "tiled", "pallas-tree"])
@pytest.mark.parametrize(
    "name,pts,eps,mp,want", _degenerate_cases(),
    ids=[c[0] for c in _degenerate_cases()])
def test_degenerate_parameters(algorithm, name, pts, eps, mp, want):
    res = _run(pts, eps, mp, algorithm=algorithm)
    labs = res.labels.numpy()
    core = res.core_mask.numpy()
    assert res.n_clusters == want
    assert labs.shape == (len(pts),) and core.shape == (len(pts),)
    if want == 0:
        assert (labs == -1).all() and not core.any()
    elif want == 1:
        assert (labs == 0).all() and core.all()
    elif want == 2:
        assert core.all() and labs[0] != labs[20]
        assert (labs[:20] == labs[0]).all() and (labs[20:] == labs[20]).all()
    check_dbscan(pts, eps, mp, labs, core)


def test_negative_eps_and_bad_points_raise():
    pts = separated_points(50, 2, eps=0.1, seed=0)
    with pytest.raises(ValueError, match="non-negative"):
        _run(pts, -0.1, 3)
    with pytest.raises(ValueError, match="non-negative"):
        _run(pts, -0.1, 3, algorithm="fdbscan")
    bad = pts.copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        _run(bad, 0.1, 3)
    with pytest.raises(ValueError, match="unknown algorithm"):
        _run(pts, 0.1, 3, algorithm="nope")


@pytest.mark.parametrize("algorithm", ["sharded", "stream"])
def test_later_backends_name_their_roadmap_item(algorithm):
    """``sharded`` and ``mesh=`` name the ROADMAP item that brings them;
    ``stream``, which the port has now, runs (and refuses ``mesh=``)."""
    pts = separated_points(50, 2, eps=0.1, seed=0)
    if algorithm == "stream":
        assert _run(pts, 0.1, 3, algorithm=algorithm).backend == "stream"
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _run(pts, 0.1, 3, algorithm=algorithm)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(pts, 0.1, 3, algorithm=algorithm, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(pts, 0.1, 3, mesh=object())


def test_plan_cache_hit_and_shared_index():
    dispatch.clear_cache()
    pts = pointclouds.load("blobs", 1200)
    p1 = dispatch.plan(pts, 0.05, 8, algorithm="fdbscan", device="cpu")
    p2 = dispatch.plan(pts, 0.05, 8, algorithm="fdbscan", device="cpu")
    assert p2 is p1                              # LRU hit
    p3 = dispatch.plan(pts, 0.07, 4, algorithm="fdbscan", device="cpu")
    assert p3 is not p1 and p3.segs is p1.segs   # eps-independent index
    res = repro_torch.dbscan(pts, 0.05, 8, query_plan=p1)
    fresh = _run(pts, 0.05, 8, algorithm="fdbscan")
    _assert_same(fresh, res)
    assert dispatch.cache_info()["entries"] == 3
    dispatch.clear_cache()
    assert dispatch.cache_info()["entries"] == 0


def test_auto_names_the_kernel_backend_only_on_cuda():
    # the auto tree decision is named "pallas-tree" only where the walk is
    # the kernel: an index on a CUDA device; the renamed plan carries its
    # tuner state (on the CPU auto attaches none)
    pts = pointclouds.load("blobs", 2000)
    p = dispatch.plan(pts, 0.05, 8, device="cpu")
    assert p.backend in ("fdbscan", "fdbscan-densebox")
    assert p.tune is None
    fake = p._replace(device=torch.device("cuda", 0))
    named = dispatch._maybe_kernel(fake, "auto", 0.05, 8)
    assert named.backend == "pallas-tree"
    assert named.tune is not None and "tuned_config" in named.stats
    assert dispatch._maybe_kernel(fake, "fdbscan", 0.05, 8).backend \
        == p.backend


# the reference's committed work counters at n = 4096
# (benchmarks/bench_phase_cost.py counters, BENCH_traversal.json)
PHASE_COST = [("portotaxi_like", 0.01, 50), ("hacc_like", 0.03, 5),
              ("ngsim_like", 0.005, 100)]


@pytest.mark.parametrize("dset,eps,minpts_full", PHASE_COST,
                         ids=[c[0] for c in PHASE_COST])
def test_phase_cost_counters_match_committed_reference(dset, eps,
                                                       minpts_full):
    import json
    from repro_torch.core import grid, lbvh, traversal
    with open(os.path.join(os.path.dirname(HERE),
                           "BENCH_traversal.json")) as f:
        want = json.load(f)[dset]
    n = 4096
    mp = max(3, minpts_full * n // 16384)
    pts = torch.from_numpy(pointclouds.load(dset, n))
    segs = grid.build_segments_densebox(pts, eps, mp)
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    core, labels0, vals0, absorbed, first = fdbscan._fused_first_pass(
        tree, segs, eps, mp)
    # the fused pass at the walk kernel's unroll (the Pallas counters)
    first4 = traversal.traverse(
        tree, segs, traversal.intersects(traversal.sphere(eps)),
        traversal.CountMinLabelVisitor(vals0, torch.ones(n, dtype=torch.bool),
                                       cap=mp - 1), unroll=4)
    _, sweeps, stats = fdbscan._sweep_to_fixpoint(
        tree, segs, eps, core, labels0, collect_stats=True,
        fused_init=(vals0, absorbed))
    assert int(first.evals.sum()) == int(first4.evals.sum()) \
        == want["pallas_evals"]
    assert int(first.iters.sum()) == want["loop_iters_after_fusion"]
    assert int(first4.iters.sum()) == want["pallas_loop_iters"]
    assert 1 + sweeps == want["n_sweeps"]
    assert stats["iters_per_sweep"] == want["sweep_iters_per_sweep"]
    assert stats["frontier_per_sweep"] == want["frontier_per_sweep"]
    assert stats["active_per_sweep"] == want["active_queries_per_sweep"]
