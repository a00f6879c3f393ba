"""Neighbor-query parity: ``repro_torch.neighbors`` on the CPU against the
live JAX package's ``repro.neighbors`` on the same inputs.

Tolerance: zero. Indices, counts and carries are equal and distances are
bitwise equal: the port's walk takes the reference's steps with the same
float32 roundings (the squared distances of the walk as its compiled code
rounds them, those of the brute paths as its eager code rounds them, and
correctly rounded square roots). The k-NN walk kernel (``csrc/knn.cu``)
takes the plain engine's steps one thread per lane and is held against it
on the card by ``chip_smoke.py``.
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
import jax.numpy as jnp  # noqa: E402

from repro.core import dispatch as jdispatch  # noqa: E402
from repro.core import grid as jgrid, lbvh as jlbvh  # noqa: E402
from repro.core import neighbors as jneighbors  # noqa: E402
from repro.core import traversal as jtraversal  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import index_from_numpy  # noqa: E402
from repro_torch.core import dispatch, traversal  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.kernels import knn as kknn, walkpack  # noqa: E402

neighbors = repro_torch.neighbors
CPU = torch.device("cpu")
# The reference compiles its index build and walks per shape, which is most
# of this file's time, so most cases share these two point sets.
BLOBS = pointclouds.load("blobs", 700)
LATTICE = np.stack(np.meshgrid(np.arange(7.0), np.arange(7.0)),
                   -1).reshape(-1, 2).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh_caches():
    dispatch.clear_cache()
    jdispatch.clear_cache()
    yield
    dispatch.clear_cache()
    jdispatch.clear_cache()


def _assert_knn_equal(ref, port):
    ri, rd = np.asarray(ref.indices), np.asarray(ref.distances)
    assert port.indices.dtype == torch.int32
    assert port.distances.dtype == torch.float32
    np.testing.assert_array_equal(ri, port.indices.numpy())
    np.testing.assert_array_equal(rd.view(np.int32),
                                  port.distances.numpy().view(np.int32))


def _check_knn(pts, k, query_pts=None, radius=None):
    ref = jneighbors.knn(pts, k, query_pts=query_pts, radius=radius)
    port = neighbors.knn(pts, k, query_pts=query_pts, radius=radius,
                         device="cpu")
    _assert_knn_equal(ref, port)
    return port


@pytest.mark.parametrize("dset,n", [("blobs", 700), ("hacc_like", 600)])
def test_knn_matches_reference(dset, n):
    pts = pointclouds.load(dset, n)
    res = _check_knn(pts, 5)
    # a resident query's nearest neighbor is itself at distance 0
    np.testing.assert_array_equal(res.indices[:, 0].numpy(), np.arange(n))
    assert not res.distances[:, 0].any()


def test_knn_external_queries():
    q = np.random.default_rng(0).uniform(-0.1, 1.1,
                                         size=(64, 2)).astype(np.float32)
    _check_knn(BLOBS, 4, query_pts=q)


def test_knn_ties_at_radius_resolve_by_index():
    # integer lattice: d2 is exact, so equidistant rings are true ties, and
    # k cuts inside a tie group: the smallest *original* index wins
    pts = LATTICE[np.random.default_rng(1).permutation(len(LATTICE))]
    for k in (2, 3, 4, 6):
        _check_knn(pts, k)
    _check_knn(pts, 3, query_pts=np.array([[3.0, 3.0]], np.float32))


def test_knn_k_exceeds_n():
    res = _check_knn(LATTICE + np.float32(0.25), 64)
    assert (res.indices[:, 49:] == -1).all()
    assert torch.isinf(res.distances[:, 49:]).all()


def test_knn_radius_capped():
    res = _check_knn(BLOBS, 8, radius=0.02)
    assert (res.indices == -1).any()        # the cap cut some lists short


def test_knn_degenerate_inputs():
    one = np.zeros((1, 2), np.float32)
    res = _check_knn(one, 3)
    assert res.indices.tolist() == [[0, -1, -1]]
    with pytest.raises(ValueError):
        neighbors.knn(one, 0, device="cpu")
    # d outside the Morton range takes the exact brute fallback
    pts5 = np.random.default_rng(4).normal(size=(50, 5)).astype(np.float32)
    _check_knn(pts5, 4)
    _check_knn(pts5, 4, query_pts=pts5[:7] + np.float32(0.01))


def test_neighbor_count_matches_reference():
    pts, r = BLOBS, 0.05
    q = pts[:32] + np.float32(1e-3)
    for kw in ({}, {"cap": 5}, {"query_pts": q, "cap": 3}):
        ref = np.asarray(jneighbors.neighbor_count(pts, r, **kw))
        port = neighbors.neighbor_count(pts, r, device="cpu", **kw)
        assert port.dtype == torch.int32
        np.testing.assert_array_equal(ref, port.numpy())


def _grid_points(n, d, seed):
    """Points on the levels {0, 0.1, 0.2} with 1e-7 jitter, and a radius on
    one of their distance shells: many pairs lie at r and the ulps around
    it, where any other rounding of the squared distance changes counts."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 3, (n, d))
    pts = (cells * 0.1 + rng.uniform(-1e-7, 1e-7, (n, d))).astype(np.float32)
    c = cells[:100]
    shell = np.median(((c[:, None] - c[None]) ** 2).sum(-1))
    return pts, float(0.1 * np.sqrt(max(shell, 1)))


@pytest.mark.parametrize("d", [1, 4, 5, 8, 17, 33, 64])
def test_neighbor_count_brute_path_rounds_as_reference(d):
    pts, r = _grid_points(300, d, seed=d)
    q = pts[:40] + np.float32(1e-7)
    for kw in ({}, {"query_pts": q, "cap": 20}):
        ref = np.asarray(jneighbors.neighbor_count(pts, r, **kw))
        port = neighbors.neighbor_count(pts, r, device="cpu", **kw)
        np.testing.assert_array_equal(ref, port.numpy())


def test_neighbor_count_single_point():
    one = np.array([[0.5, 0.5]], np.float32)
    q = np.array([[0.5, 0.52], [0.9, 0.9]], np.float32)
    for kw in ({}, {"query_pts": q}):
        ref = np.asarray(jneighbors.neighbor_count(one, 0.05, **kw))
        port = neighbors.neighbor_count(one, 0.05, device="cpu", **kw)
        np.testing.assert_array_equal(ref, port.numpy())


def test_neighbors_share_the_dispatch_index():
    # knn, neighbor_count and dbscan runs on one point set hit one cached
    # eps-independent index build
    pts = BLOBS
    p0 = dispatch.plan(pts, 0.05, 5, algorithm="fdbscan", device="cpu")
    neighbors.knn(pts, 3, device="cpu")
    neighbors.neighbor_count(pts, 0.02, device="cpu")
    p1 = dispatch.plan(pts, 0.09, 3, algorithm="fdbscan", device="cpu")
    assert p0.segs is p1.segs and p0.tree is p1.tree


@jax.tree_util.register_pytree_node_class
class _JaxWeightSum(jtraversal.Visitor):
    """Reference test double: sum(weights[j]) over in-radius neighbors,
    a bare-array carry."""

    def __init__(self, weights):
        self.weights = weights

    def tree_flatten(self):
        return (self.weights,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def init_carry(self, ids, external, segs):
        return jnp.zeros(ids.shape, self.weights.dtype)

    def visit(self, carry, j, d2, hit, ctx):
        return carry + jnp.where(hit, self.weights[j], 0), hit


class _WeightSum(traversal.Visitor):
    """The port's test double: the same visitor over lane vectors."""

    def __init__(self, weights):
        self.weights = weights

    def init_carry(self, ids, external, segs):
        return torch.zeros(ids.shape, dtype=self.weights.dtype)

    def visit(self, carry, j, d2, hit, ctx):
        return carry + torch.where(hit, self.weights[j], 0), hit


def test_radius_visit_bare_tensor_carry():
    pts = BLOBS
    w = np.random.default_rng(3).integers(1, 10, size=700).astype(np.int32)
    jp = jdispatch.plan(pts, 0.07, 5, algorithm="fdbscan")
    p = dispatch.plan(pts, 0.07, 5, algorithm="fdbscan", device="cpu")
    order = p.segs.order.numpy()
    np.testing.assert_array_equal(np.asarray(jp.segs.order), order)
    runs = traversal.traverse.runs
    ref = jneighbors.radius_visit(pts, 0.07,
                                  _JaxWeightSum(jnp.asarray(w[order])))
    port = neighbors.radius_visit(pts, 0.07,
                                  _WeightSum(torch.from_numpy(w[order])),
                                  device="cpu")
    assert isinstance(port.carry, torch.Tensor)
    np.testing.assert_array_equal(np.asarray(ref.carry), port.carry.numpy())
    np.testing.assert_array_equal(np.asarray(ref.evals), port.evals.numpy())
    # a seeded carry chains a second walk
    ref2 = jneighbors.radius_visit(pts, 0.07,
                                   _JaxWeightSum(jnp.asarray(w[order])),
                                   carry=ref.carry)
    port2 = neighbors.radius_visit(pts, 0.07,
                                   _WeightSum(torch.from_numpy(w[order])),
                                   carry=port.carry, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref2.carry), port2.carry.numpy())
    assert traversal.traverse.runs == runs + 2     # the plain engine ran
    with pytest.raises(ValueError):
        neighbors.radius_visit(pts[:1], 0.07, _WeightSum(torch.ones(1)),
                               device="cpu")


@pytest.fixture(scope="module")
def hacc_index():
    pts = jnp.asarray(pointclouds.load("hacc_like", 600))
    jsegs = jgrid.build_segments_fdbscan(pts)
    jtree = jlbvh.build_tree(jsegs.codes, jsegs.prim_lo, jsegs.prim_hi)
    segs, tree = index_from_numpy(
        {f: np.asarray(getattr(jsegs, f)) for f in jsegs._fields},
        {f: np.asarray(getattr(jtree, f)) for f in jtree._fields}, CPU)
    return (jsegs, jtree), (segs, tree)


@pytest.mark.parametrize("k,radius,lanes,unroll", [
    (1, None, "resident", 1), (16, None, "compacted", 4),
    (6, 0.06, "external", 1),
    # the edges of the kernel's list bodies: a register list at its
    # capacity, and the first k held in device memory
    (8, None, "external", 4), (17, 0.08, "resident", 1)])
def test_plain_knn_walk_counters_match_reference(hacc_index, k, radius,
                                                 lanes, unroll):
    (jsegs, jtree), (segs, tree) = hacc_index
    n = segs.n_points
    rng = np.random.default_rng(k)
    ids = pts = None
    if lanes == "compacted":        # a compacted id vector with inert lanes
        ids = np.full(64, -1, np.int32)
        ids[:50] = np.sort(rng.choice(n, 50, replace=False))
    elif lanes == "external":
        pts = rng.uniform(0, 1, (40, 3)).astype(np.float32)

    def arr(x, conv):
        return None if x is None else conv(x)

    ref = jtraversal.traverse(
        jtree, jsegs,
        jtraversal.nearest(k, r=radius, ids=arr(ids, jnp.asarray),
                           pts=arr(pts, jnp.asarray)),
        jtraversal.KNNVisitor(k, id_map=jsegs.order), unroll=unroll)
    # the k-NN kernel's entry: for CPU tensors, the plain engine with
    # KNNVisitor(k, id_map=segs.order)
    runs = traversal.traverse.runs
    port = kknn.traverse(
        tree, segs,
        traversal.nearest(k, r=radius, ids=arr(ids, torch.from_numpy),
                          pts=arr(pts, torch.from_numpy)), unroll=unroll)
    assert traversal.traverse.runs == runs + 1
    assert isinstance(port.carry, traversal.KNNCarry)
    np.testing.assert_array_equal(np.asarray(ref.carry.ids),
                                  port.carry.ids.numpy())
    np.testing.assert_array_equal(np.asarray(ref.carry.d2).view(np.int32),
                                  port.carry.d2.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(ref.evals), port.evals.numpy())
    np.testing.assert_array_equal(np.asarray(ref.iters), port.iters.numpy())


@pytest.mark.parametrize("k,capacity", [
    (1, 4), (4, 4), (5, 8), (8, 8), (9, 16), (16, 16), (17, 0), (100, 0)])
def test_knn_kernel_list_body_choice(k, capacity):
    # the k-NN kernel's body: the smallest register-list capacity that
    # holds k, the list in device memory (0) above 16
    assert kknn.list_capacity(k) == capacity
    assert capacity == 0 or capacity in kknn.CAPACITIES


def test_knn_kernel_entry_refuses_cpu_tensors(hacc_index):
    _, (segs, tree) = hacc_index
    n = segs.n_points
    launches = kknn.walk.launches
    with pytest.raises(ValueError, match="CUDA"):
        kknn.walk(q=segs.pts, qid=torch.zeros(n, dtype=torch.int32),
                  index=walkpack.pack_index(tree, segs),
                  order=segs.order.to(torch.int32), k=4, r2=float("inf"))
    with pytest.raises(TypeError):
        kknn.traverse(tree, segs, traversal.intersects(0.1))
    assert kknn.walk.launches == launches


def test_top_level_exports():
    # the reference's public surface, stream_handle included
    assert set(repro_torch.__all__) == {"DBSCANResult", "dbscan", "plan",
                                        "stream_handle", "neighbors",
                                        "__version__"}
    pts = pointclouds.blobs(300, seed=1)
    assert repro_torch.neighbors.knn(
        pts, 2, device="cpu").indices.shape == (300, 2)
