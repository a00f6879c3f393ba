"""The node-flag kernel (``csrc/nodeflags.cu``) against the reference's
level-synchronous loop (``lbvh.propagate_leaf_flags_by_level``), byte for
byte, and the routing of ``lbvh.propagate_leaf_flags`` and
``fdbscan._frontier_node_mask`` by the device of their input.

Tests marked ``cuda`` need the card and skip here; run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_nodeflags.py``.
The others run on the CPU: the routing to the loop, the wrapper's checks,
and the kernel's climb written out in numpy against the loop. This file
imports no JAX (the loop is held to the reference in test_torch_index.py).

Tolerance: zero; the masks are compared byte for byte.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores.
torch.set_num_threads(1)

import repro_torch  # noqa: E402
from repro_torch.core import dispatch, fdbscan, grid, lbvh  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.kernels import nodeflags  # noqa: E402
from repro_torch.obs import metrics, names  # noqa: E402


# (dataset, d, eps, min_pts): the cases of test_torch_index.py
CASES = [
    ("ngsim_like", 2, 0.01, 5),
    ("portotaxi_like", 2, 0.02, 5),
    ("road3d_like", 2, 0.01, 5),
    ("hacc_like", 3, 0.05, 5),
    ("blobs", 3, 0.08, 6),
]
N = 1500
FLAG_SETS = ["none", "all", "random5", "deepest"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the node-flag kernel runs only on "
                    "the card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _index(dset, d, eps, mp, index):
    """(segs, tree) on the CPU, built once per case."""
    if dset == "blobs":
        pts = pointclouds.blobs(N, d=3, seed=4)
    else:
        pts = pointclouds.load(dset, N)
    pts = torch.from_numpy(pts)
    segs = (grid.build_segments_fdbscan(pts) if index == "fdbscan"
            else grid.build_segments_densebox(pts, eps, mp))
    return segs, lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)


def _deepest_leaf(parent: np.ndarray) -> int:
    n_int = (parent.shape[0] - 1) // 2

    def depth(node):
        k = 0
        while parent[node] >= 0:
            node, k = parent[node], k + 1
        return k
    return max(range(n_int + 1), key=lambda leaf: depth(n_int + leaf))


def _leaf_flags(kind: str, parent: np.ndarray) -> np.ndarray:
    m = (parent.shape[0] + 1) // 2
    if kind == "none":
        return np.zeros(m, bool)
    if kind == "all":
        return np.ones(m, bool)
    if kind == "random5":
        return np.random.default_rng(1).random(m) < 0.05
    out = np.zeros(m, bool)
    out[_deepest_leaf(parent)] = True
    return out


def _point_flags(kind: str, segs, parent: np.ndarray) -> np.ndarray:
    """Per-point flags of each set: the deepest leaf's points for
    ``deepest``; else drawn per point."""
    if kind == "deepest":
        return segs.seg_of_point.numpy() == _deepest_leaf(parent)
    if kind == "random5":
        return np.random.default_rng(2).random(segs.n_points) < 0.05
    return np.full(segs.n_points, kind == "all")


def _oracle(tree, segs, flags: np.ndarray, entry: str) -> np.ndarray:
    return lbvh.propagate_leaf_flags_by_level(
        tree, torch.from_numpy(flags),
        segs.seg_of_point if entry == "point" else None).numpy()


def _to(x, dev):
    return type(x)(*(t.to(dev) if isinstance(t, torch.Tensor) else t
                     for t in x))


def _syncs(reg) -> dict:
    return {s["labels"]["site"]: s["value"]
            for m in reg.snapshot()["metrics"] if m["name"] == names.HOST_SYNCS
            for s in m["series"]}


def _launches(reg) -> float:
    return sum(s["value"] for m in reg.snapshot()["metrics"]
               if m["name"] == names.NODE_FLAG_LAUNCHES for s in m["series"])


# --------------------------------------------------------------------- #
# on the CPU                                                            #
# --------------------------------------------------------------------- #

def _climb(parent, flags, item_leaf=None, seed=0):
    """The kernel's algorithm written out: each flagged item, in a random
    order, climbs from its leaf and stops at the first node already set."""
    n_int = (parent.shape[0] - 1) // 2
    out = np.zeros(parent.shape[0], bool)
    items = np.flatnonzero(flags)
    np.random.default_rng(seed).shuffle(items)
    for i in items:
        node = n_int + (i if item_leaf is None else item_leaf[i])
        while node >= 0 and not out[node]:
            out[node] = True
            node = parent[node]
    return out


@pytest.mark.parametrize("entry", ["leaf", "point"])
@pytest.mark.parametrize("kind", FLAG_SETS)
@pytest.mark.parametrize("index", ["fdbscan", "densebox"])
@pytest.mark.parametrize("dset,d,eps,mp", CASES)
def test_climb_equals_level_loop(dset, d, eps, mp, index, kind, entry):
    segs, tree = _index(dset, d, eps, mp, index)
    parent = tree.parent.numpy()
    if entry == "leaf":
        flags = _leaf_flags(kind, parent)
        got = _climb(parent, flags)
    else:
        flags = _point_flags(kind, segs, parent)
        got = _climb(parent, flags, segs.seg_of_point.numpy())
    want = _oracle(tree, segs, flags, entry)
    assert want.dtype == got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entry", ["leaf", "point"])
def test_cpu_takes_the_level_loop_and_counts_its_reads(entry, monkeypatch):
    def no_kernel(*args, **kw):
        raise AssertionError("the kernel was reached on the CPU")
    monkeypatch.setattr(nodeflags, "node_flags", no_kernel)
    segs, tree = _index("hacc_like", 3, 0.05, 5, "densebox")
    parent = tree.parent.numpy()
    prev = metrics.active()
    try:
        loop = metrics.install()
        if entry == "leaf":
            flags = torch.from_numpy(_leaf_flags("random5", parent))
            want = lbvh.propagate_leaf_flags_by_level(tree, flags)
            reg = metrics.install()
            got = lbvh.propagate_leaf_flags(tree, flags)
        else:
            flags = torch.from_numpy(_point_flags("random5", segs, parent))
            want = lbvh.propagate_leaf_flags_by_level(tree, flags,
                                                      segs.seg_of_point)
            reg = metrics.install()
            got = fdbscan._frontier_node_mask(tree, segs, flags)
    finally:
        metrics.install(prev) if prev is not None else metrics.uninstall()
    assert torch.equal(got, want)
    assert _syncs(reg) == _syncs(loop)
    assert _syncs(reg)["lbvh.leaf_flags"] > 1     # one read a round
    assert _launches(reg) == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    segs, tree = _index("portotaxi_like", 2, 0.02, 5, "densebox")
    parent, m = tree.parent, segs.n_segments
    leaf = torch.zeros(m, dtype=torch.bool)
    pts = torch.zeros(segs.n_points, dtype=torch.bool)
    with pytest.raises(TypeError, match="parent"):
        nodeflags.node_flags(parent.long(), leaf)
    with pytest.raises(ValueError, match="parent"):
        nodeflags.node_flags(parent[:-1], leaf)
    with pytest.raises(ValueError, match="flags"):
        nodeflags.node_flags(parent, leaf[:-1])
    with pytest.raises(TypeError, match="flags"):
        nodeflags.node_flags(parent, leaf.to(torch.uint8))
    with pytest.raises(ValueError, match="flags"):
        nodeflags.node_flags(parent, leaf, segs.seg_of_point)
    with pytest.raises(TypeError, match="item_leaf"):
        nodeflags.node_flags(parent, pts, segs.seg_of_point.long())
    with pytest.raises(ValueError, match="contiguous"):
        nodeflags.node_flags(parent, pts, torch.stack(
            [segs.seg_of_point, segs.seg_of_point], 1)[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        nodeflags.node_flags(parent, pts, segs.seg_of_point)
    with pytest.raises(ValueError, match="CUDA"):
        nodeflags.node_flags(parent, leaf)
    assert nodeflags.node_flags.launches == 0


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["leaf", "point"])
@pytest.mark.parametrize("kind", FLAG_SETS)
@pytest.mark.parametrize("index", ["fdbscan", "densebox"])
@pytest.mark.parametrize("dset,d,eps,mp", CASES)
def test_kernel_equals_level_loop(card, dset, d, eps, mp, index, kind,
                                  entry):
    segs, tree = _index(dset, d, eps, mp, index)
    parent = tree.parent.numpy()
    before = nodeflags.node_flags.launches
    if entry == "leaf":
        flags = _leaf_flags(kind, parent)
        got = lbvh.propagate_leaf_flags(_to(tree, card),
                                        torch.from_numpy(flags).to(card))
    else:
        flags = _point_flags(kind, segs, parent)
        got = fdbscan._frontier_node_mask(_to(tree, card), _to(segs, card),
                                          torch.from_numpy(flags).to(card))
    torch.cuda.synchronize()
    assert nodeflags.node_flags.launches == before + 1
    assert got.dtype == torch.bool and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle(tree, segs, flags, entry))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_kernel_on_a_two_leaf_tree(card, flags):
    pts = torch.tensor([[0.1, 0.2], [0.7, 0.4]])
    segs = grid.build_segments_fdbscan(pts)
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    f = torch.tensor(flags, dtype=torch.bool)
    want = lbvh.propagate_leaf_flags_by_level(tree, f).numpy()
    np.testing.assert_array_equal(
        lbvh.propagate_leaf_flags(_to(tree, card), f.to(card)).cpu().numpy(),
        want)
    np.testing.assert_array_equal(
        fdbscan._frontier_node_mask(_to(tree, card), _to(segs, card),
                                    f.to(card)).cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all", "random5", "none"])
def test_kernel_equals_level_loop_at_a_million_points(card, kind):
    # thousands of blocks racing up shared paths
    pts = torch.from_numpy(pointclouds.load("hacc_like", 1 << 20)).to(card)
    segs = grid.build_segments_densebox(pts, 0.01, 5)
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    flags = _point_flags(kind, segs, None)
    f = torch.from_numpy(flags).to(card)
    want = lbvh.propagate_leaf_flags_by_level(tree, f, segs.seg_of_point)
    got = fdbscan._frontier_node_mask(tree, segs, f)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dset,eps,mp", [("portotaxi_like", 0.02, 5),
                                         ("hacc_like", 0.05, 5)])
def test_resident_call_reads_no_leaf_flags(card, dset, eps, mp, monkeypatch):
    pts = pointclouds.load(dset, 4096)
    masks = []
    real = fdbscan._frontier_node_mask

    def counted(*args):
        masks.append(1)
        return real(*args)
    monkeypatch.setattr(fdbscan, "_frontier_node_mask", counted)
    dispatch.clear_cache()
    try:
        host = repro_torch.dbscan(pts, eps, mp, device="cpu")
        repro_torch.dbscan(pts, eps, mp, device=card)      # plans
        masks.clear()
        prev = metrics.active()
        reg = metrics.install()
        try:
            res = repro_torch.dbscan(pts, eps, mp, device=card)  # resident
        finally:
            metrics.install(prev) if prev is not None else metrics.uninstall()
    finally:
        dispatch.clear_cache()
    assert res.n_sweeps > 0 and len(masks) > res.n_sweeps
    assert _syncs(reg).get("lbvh.leaf_flags", 0) == 0
    assert _launches(reg) == len(masks)
    assert torch.equal(res.labels.cpu(), host.labels)
    assert torch.equal(res.core_mask.cpu(), host.core_mask)
    assert (res.n_sweeps, res.n_clusters) == (host.n_sweeps, host.n_clusters)
