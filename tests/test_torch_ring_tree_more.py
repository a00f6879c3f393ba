"""The rest of the sharded tree path's cases against the reference's live
sharded programs (see ``test_torch_ring_tree.py`` for the oracle): the
hacc_like and blobs scenarios, a cluster that straddles many shards, and
``auto`` dispatch under a mesh. P = 8 shards on a ``LocalMesh``; labels,
core mask, ``n_clusters``, ``n_sweeps`` and every phase's per-lane
``evals`` byte-equal (zero tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

import repro_torch  # noqa: E402
from repro_torch.core import dispatch, morton  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402

from conftest import separated_points  # noqa: E402
from test_torch_ring_tree import (  # noqa: E402
    SCENARIOS, JaxOracle, assert_same, assert_same_evals, run_programs,
    sharded_case)

HERE_CASES = SCENARIOS[3:]


def strip_points():
    """tests/test_ring_tree.py's straddling strip: one thin dense strip
    whose single cluster crosses >= 3 shard boundaries, a distant blob and
    a sparse noise band (eps 0.01, min_pts 4)."""
    rng = np.random.default_rng(0)
    xs = np.linspace(0.0, 1.0, 800).astype(np.float32)
    strip = np.stack([xs, 0.5 + 1e-3 * np.sin(37.0 * xs)], -1)
    blob = rng.uniform(0.0, 0.05, size=(120, 2)).astype(np.float32) \
        + np.asarray([0.1, 0.9], np.float32)
    noise = np.stack([rng.uniform(0, 1, 80),
                      rng.uniform(0.05, 0.12, 80)], -1).astype(np.float32)
    return np.concatenate([strip, blob, noise]).astype(np.float32)


AUTO = ("auto", separated_points(1200, 2, eps=0.05, seed=4), 0.05, 6)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    cases = [sharded_case(d, eps, mp) for d, _, eps, mp in HERE_CASES]
    points = {d: pointclouds.load(d, n) for d, n, _, _ in HERE_CASES}
    cases.append(sharded_case("strip", 0.01, 4))
    points["strip"] = strip_points()
    cases.append(sharded_case("auto", AUTO[2], AUTO[3]))
    points["auto"] = AUTO[1]
    o = JaxOracle(str(tmp_path_factory.mktemp("oracle")), cases, points)
    yield o
    o.close()


@pytest.mark.parametrize("dset,n,eps,mp", HERE_CASES,
                         ids=[s[0] for s in HERE_CASES])
def test_sharded_matches_live_reference(oracle, dset, n, eps, mp):
    res, evals = run_programs(pointclouds.load(dset, n), eps, mp)
    want = oracle.get(dset)
    assert_same(res, want, dset)
    assert_same_evals(evals, want, dset)


def test_sharded_cluster_straddles_many_shards(oracle):
    pts = strip_points()
    # the strip occupies >= 4 distinct shards of the slab partition
    _, order, _ = morton.morton_sort(torch.from_numpy(pts))
    pos = np.empty(len(pts), np.int64)
    pos[order.numpy()] = np.arange(len(pts))
    assert len(np.unique(pos[:800] // -(-len(pts) // 8))) >= 4
    res, evals = run_programs(pts, 0.01, 4)
    want = oracle.get("strip")
    assert_same(res, want, "strip")
    assert_same_evals(evals, want, "strip")
    # the strip is one cluster despite the shard cuts
    strip = np.unique(res.labels.numpy()[:800])
    assert len(strip) == 1 and strip[0] >= 0


def test_sharded_auto_dispatch_under_mesh(oracle):
    _, pts, eps, mp = AUTO
    mesh = sharding.LocalMesh(8)
    p = dispatch.plan(pts, eps, mp, mesh=mesh, device="cpu")
    assert p.backend == "sharded" and p.stats["ndev"] == 8
    assert p.stats["mesh"] is mesh and p.segs is None
    res = repro_torch.dbscan(pts, eps, mp, algorithm="auto", mesh=mesh,
                             device="cpu")
    assert res.backend == "sharded"
    want = oracle.get("auto")
    assert_same(res, want, "auto")
    _, evals = run_programs(pts, eps, mp)
    assert_same_evals(evals, want, "auto")
