"""The walk kernel's packed index layout and its contract with the plain
engine, on the CPU.

* The packed layout (``repro_torch.kernels.walkpack.pack_index``) decodes
  back to the index's ``Tree`` and ``Segments`` byte for byte, on the
  densebox indexes of ``tests/test_torch_traversal.py``, an index whose
  every segment is dense and one of two segments.
* The ``iters`` identity the kernel relies on: a lane that does U work
  units (node steps plus member tests) takes ceil(U / unroll) loop trips,
  so ``iters`` at ``unroll=4`` is ``ceil(iters at unroll=1 / 4)``. Held on
  the JAX engine for each visitor, with the port's plain engine equal to
  it at both unrolls. Tolerance: zero.
* The kernel's wrapper refuses CPU tensors and packed inputs of the wrong
  shape, type, contiguity or alignment before anything launches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import grid as jgrid, lbvh as jlbvh  # noqa: E402
from repro.core import traversal as jtraversal  # noqa: E402

from repro_torch.convert import index_from_numpy  # noqa: E402
from repro_torch.core import dispatch, fdbscan, grid, lbvh  # noqa: E402
from repro_torch.core import traversal  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.kernels import traverse as kt, walkpack  # noqa: E402

CPU = torch.device("cpu")
INT_MAX = 2**31 - 1
# the densebox indexes of tests/test_torch_traversal.py
INDEXES = {"porto2d": ("portotaxi_like", 480, 0.05, 8),
           "hacc3d": ("hacc_like", 400, 0.08, 5)}


def _jax_index(key):
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
    return {k: _jax_index(k) for k in INDEXES}


def _all_dense():
    # tight groups of 12 points, min_pts 4: every cell is dense
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 1, (20, 3))
    pts = (centers[:, None, :] + rng.uniform(0, 1e-3, (20, 12, 3)))
    segs = grid.build_segments_densebox(
        torch.from_numpy(pts.reshape(-1, 3).astype(np.float32)), 0.05, 4)
    assert bool(segs.dense_seg.all()) and segs.n_segments > 2
    return segs


def _two_segments():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(0.1, 0.1001, (6, 2)),
                          rng.uniform(0.9, 0.9001, (7, 2))])
    segs = grid.build_segments_densebox(
        torch.from_numpy(pts.astype(np.float32)), 0.05, 5)
    assert segs.n_segments == 2
    return segs


def _assert_round_trip(segs, tree):
    w = walkpack.pack_index(tree, segs)
    n, d = segs.pts.shape
    m = segs.n_segments
    nodes = w.nodes
    assert nodes.dtype == torch.int32 and nodes.shape == (2 * m - 1, 8)
    assert w.d == d and w.n_segments == m
    f32 = nodes.contiguous().view(torch.float32)
    assert torch.equal(f32[:, :d].contiguous().view(torch.int32),
                       tree.box_lo.contiguous().view(torch.int32))
    assert torch.equal(f32[:, d:2 * d].contiguous().view(torch.int32),
                       tree.box_hi.contiguous().view(torch.int32))
    assert torch.equal(nodes[:, walkpack.MISS_WORD], tree.miss)
    assert torch.equal(nodes[:m - 1, walkpack.LINK_WORD], tree.left)
    link = nodes[m - 1:, walkpack.LINK_WORD]
    assert torch.equal(torch.where(link < 0, ~link, link), segs.seg_start)
    # a negative link marks exactly the one-member leaves whose box is the
    # member's point, bit for bit
    member = segs.pts[segs.seg_start.long()].view(torch.int32)
    single = ((segs.seg_end - segs.seg_start == 1)
              & (tree.box_lo[m - 1:].view(torch.int32) == member).all(1)
              & (tree.box_hi[m - 1:].view(torch.int32) == member).all(1))
    assert torch.equal(link < 0, single)
    assert torch.equal(w.leaf_end & INT_MAX, segs.seg_end)
    assert torch.equal(w.leaf_end < 0, segs.dense_seg)
    used = list(range(2 * d)) + [walkpack.MISS_WORD, walkpack.LINK_WORD]
    if d == 2:
        assert torch.equal(nodes[m - 1:, walkpack.LEAF_END_WORD_2D],
                           w.leaf_end)
        assert not bool(nodes[:m - 1, walkpack.LEAF_END_WORD_2D].any())
        used.append(walkpack.LEAF_END_WORD_2D)
    pad = [k for k in range(8) if k not in used]
    assert not bool(nodes[:, pad].any())
    # points: one vector load each, the fourth lane of a 3-D point is 0
    width = 4 if d == 3 else 2
    assert w.pts.shape == (n, width) and w.pts.is_contiguous()
    assert torch.equal(w.pts[:, :d].contiguous().view(torch.int32),
                       segs.pts.contiguous().view(torch.int32))
    if d == 3:
        assert not bool(w.pts[:, 3].any())
    return w


@pytest.mark.parametrize("key", sorted(INDEXES))
def test_pack_round_trips_the_index(indexes, key):
    (_, _), (segs, tree), _, _ = indexes[key]
    w = _assert_round_trip(segs, tree)
    # both kinds of leaf occur: one-member leaves and longer segments
    link = w.nodes[segs.n_segments - 1:, walkpack.LINK_WORD]
    assert bool((link < 0).any()) and bool((link >= 0).any())


@pytest.mark.parametrize("make", [_all_dense, _two_segments],
                         ids=["all_dense", "two_segments"])
def test_pack_round_trips_small_indexes(make):
    segs = make()
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    _assert_round_trip(segs, tree)


def test_pack_refuses_what_the_kernel_does_not_take():
    segs = _two_segments()
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    with pytest.raises(ValueError, match="tree"):
        walkpack.pack_index(None, segs)
    one = segs._replace(pts=torch.zeros(segs.n_points, 4))
    with pytest.raises(ValueError, match="d must be 2 or 3"):
        walkpack.pack_index(tree, one)


# ---------------------------------------------------------------- iters #

def _visitor(ns, name, n, rng):
    arr = jnp.asarray if ns is jtraversal else torch.from_numpy
    vals = np.arange(n, dtype=np.int32)
    if name == "count_capped":
        return ns.CountVisitor(cap=5)
    if name == "count":
        return ns.CountVisitor()
    if name == "countminlabel":
        return ns.CountMinLabelVisitor(arr(vals), arr(np.ones(n, bool)),
                                       cap=4)
    return ns.MinLabelVisitor(arr(vals), arr(rng.random(n) < 0.5))


@pytest.mark.parametrize("key", sorted(INDEXES))
@pytest.mark.parametrize("name", ["count_capped", "count", "countminlabel",
                                  "minlabel_random_mask"])
def test_iters_is_ceil_of_units_over_unroll(indexes, key, name):
    (jsegs, jtree), (segs, tree), eps, _ = indexes[key]
    n = segs.n_points
    jv = _visitor(jtraversal, name, n, np.random.default_rng(7))
    tv = _visitor(traversal, name, n, np.random.default_rng(7))
    jp = jtraversal.intersects(jtraversal.sphere(eps))
    tp = traversal.intersects(traversal.sphere(eps))
    j1 = jtraversal.traverse(jtree, jsegs, jp, jv, unroll=1)
    j4 = jtraversal.traverse(jtree, jsegs, jp, jv, unroll=4)
    units = np.asarray(j1.iters)
    assert units.max() > 4            # lanes run many trips
    np.testing.assert_array_equal(np.asarray(j4.iters), -(-units // 4))
    np.testing.assert_array_equal(np.asarray(j4.evals), np.asarray(j1.evals))
    np.testing.assert_array_equal(np.asarray(j4.acc), np.asarray(j1.acc))
    for unroll, ref in ((1, j1), (4, j4)):
        port = traversal.traverse(tree, segs, tp, tv, unroll=unroll)
        np.testing.assert_array_equal(port.iters.numpy(),
                                      np.asarray(ref.iters))
        np.testing.assert_array_equal(port.evals.numpy(),
                                      np.asarray(ref.evals))


# -------------------------------------------------------------- wrapper #

def _walk_args(segs, tree, eps):
    n = segs.n_points
    z = torch.zeros(n, dtype=torch.int32)
    f = torch.zeros(n, dtype=torch.bool)
    return dict(q=segs.pts.contiguous(), qid=z, self_id=z, dense=f, rank=z,
                wide=f, acc0=z, hits0=z, r2=traversal.radius2(eps),
                index=walkpack.pack_index(tree, segs))


def _misaligned(t):
    """A contiguous copy of ``t`` whose storage starts 4 bytes off."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("key", sorted(INDEXES))
def test_wrapper_refuses_cpu_and_malformed_packed_inputs(indexes, key):
    (_, _), (segs, tree), eps, _ = indexes[key]
    args = _walk_args(segs, tree, eps)
    w = args["index"]
    launches = kt.walk.launches
    with pytest.raises(ValueError, match="CUDA"):
        kt.walk(0, **args)
    bad = {
        "misshaped nodes": (w._replace(nodes=w.nodes[:, :4].contiguous()),
                            ValueError, "shape"),
        "misaligned nodes": (w._replace(nodes=_misaligned(w.nodes)),
                             ValueError, "aligned"),
        "nodes as float": (w._replace(nodes=w.nodes.view(torch.float32)),
                           TypeError, "dtype"),
        "non-contiguous nodes": (w._replace(nodes=w.nodes.t().contiguous()
                                            .t()),
                                 ValueError, "contiguous"),
        "unpadded points": (w._replace(pts=segs.pts.contiguous())
                            if segs.pts.shape[1] == 3 else
                            w._replace(pts=w.pts[:, :1].contiguous()),
                            ValueError, "shape"),
        "misaligned points": (w._replace(pts=_misaligned(w.pts)),
                              ValueError, "aligned"),
        "short leaf_end": (w._replace(leaf_end=w.leaf_end[:-1]),
                           ValueError, "shape"),
    }
    for what, (index, exc, match) in bad.items():
        with pytest.raises(exc, match=match):
            kt.walk(0, **{**args, "index": index})
    assert kt.walk.launches == launches        # nothing launched


@pytest.mark.parametrize("kind", [1, 2], ids=["minlabel", "countminlabel"])
def test_wrapper_refuses_malformed_values_and_masks(indexes, kind):
    (_, _), (segs, tree), eps, _ = indexes["hacc3d"]
    args = _walk_args(segs, tree, eps)
    n = segs.n_points
    vals = torch.arange(n, dtype=torch.int32)
    mask = torch.ones(n, dtype=torch.bool)
    launches = kt.walk.launches
    bad = [(dict(vals=vals[:-1]), ValueError, "shape"),
           (dict(vals=vals.to(torch.int64)), TypeError, "int32 or float32"),
           (dict(vals=vals.float()), TypeError, "acc0 has dtype"),
           (dict(mask=mask.to(torch.uint8)), TypeError, "dtype"),
           (dict(mask=torch.ones(2 * n, dtype=torch.bool)[::2]), ValueError,
            "contiguous"),
           (dict(mask_wide=mask), ValueError, "minlabel kind")
           if kind == 2 else
           (dict(mask_wide=mask[:-1]), ValueError, "shape")]
    for over, exc, match in bad:
        with pytest.raises(exc, match=match):
            kt.walk(kind, **{**args, "vals": vals, "mask": mask, **over})
    with pytest.raises(ValueError, match="CUDA"):   # well formed, on the CPU
        kt.walk(kind, **{**args, "vals": vals, "mask": mask})
    assert kt.walk.launches == launches        # nothing launched


def test_cpu_plans_and_runs_pack_nothing():
    pts = pointclouds.load("hacc_like", 2000, seed=3)
    builds = walkpack.pack_index.builds
    p = dispatch.plan(pts, 0.05, 5, device="cpu")
    assert p.tree is not None and p.walk_index is None
    fdbscan.cluster_from_index(p.segs, p.tree, 0.05, 5)
    assert walkpack.pack_index.builds == builds
