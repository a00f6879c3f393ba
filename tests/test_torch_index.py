"""Index parity: the port's Morton codes, segment index builds and LBVH
against the JAX package, field by field.

Tolerance: zero. Every field is compared byte for byte (Morton codes by
value: uint32 in the reference, int64 holding the same value in the port);
each step rounds as the reference does when written as the same IEEE
float32 operations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import grid as jgrid  # noqa: E402
from repro.core import lbvh as jlbvh, morton as jmorton  # noqa: E402
from repro.core import unionfind as junionfind  # noqa: E402
from repro.data import pointclouds as jpointclouds  # noqa: E402

from repro_torch.core import grid, lbvh, morton, unionfind  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402

CPU = torch.device("cpu")

# (dataset, d, eps, min_pts): the five datasets, three 2-D and two 3-D
# (the generic blobs drawn in 3-D), so both Morton widths meet every
# index build
CASES = [
    ("ngsim_like", 2, 0.01, 5),
    ("portotaxi_like", 2, 0.02, 5),
    ("road3d_like", 2, 0.01, 5),
    ("hacc_like", 3, 0.05, 5),
    ("blobs", 3, 0.08, 6),
]
N = 1500


def _points(dset, d):
    if dset == "blobs" and d == 3:
        return jpointclouds.blobs(N, d=3, seed=4)
    return pointclouds.load(dset, N)


def _assert_fields_equal(ref, port):
    assert type(ref)._fields == type(port)._fields
    for name in type(ref)._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(port, name).numpy()
        if a.dtype == np.uint32:       # Morton codes: same value in int64
            assert b.dtype == np.int64, name
            a = a.astype(np.int64)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dset", sorted(jpointclouds.DATASETS))
def test_pointclouds_byte_identical(dset):
    for n, seed in ((777, 0), (2048, 5)):
        a = jpointclouds.load(dset, n, seed=seed)
        b = pointclouds.load(dset, n, seed=seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dset,d,eps,mp", CASES)
def test_morton_codes_and_order(dset, d, eps, mp):
    pts = _points(dset, d)
    codes = morton.morton_encode(torch.from_numpy(pts))
    np.testing.assert_array_equal(
        np.asarray(jmorton.morton_encode(jnp.asarray(pts))).astype(np.int64),
        codes.numpy())
    sp, order, sc = morton.morton_sort(torch.from_numpy(pts))
    jsp, jorder, jsc = jmorton.morton_sort(jnp.asarray(pts))
    np.testing.assert_array_equal(np.asarray(jorder), order.numpy())
    np.testing.assert_array_equal(np.asarray(jsp), sp.numpy())


@pytest.mark.parametrize("index", ["fdbscan", "densebox"])
@pytest.mark.parametrize("dset,d,eps,mp", CASES)
def test_segments_and_tree_byte_equal(dset, d, eps, mp, index):
    pts = _points(dset, d)
    if index == "fdbscan":
        ref = jgrid.build_segments_fdbscan(jnp.asarray(pts))
        port = grid.build_segments_fdbscan(torch.from_numpy(pts))
    else:
        ref = jgrid.build_segments_densebox(jnp.asarray(pts), eps, mp)
        port = grid.build_segments_densebox(torch.from_numpy(pts), eps, mp)
    _assert_fields_equal(ref, port)
    if index == "densebox":
        assert bool(port.dense_pt.any())    # the dense path is exercised
    jtree = jlbvh.build_tree(ref.codes, ref.prim_lo, ref.prim_hi)
    tree = lbvh.build_tree(port.codes, port.prim_lo, port.prim_hi)
    _assert_fields_equal(jtree, tree)
    flags = np.random.default_rng(1).random(port.n_segments) < 0.05
    np.testing.assert_array_equal(
        np.asarray(jlbvh.propagate_leaf_flags(jtree, jnp.asarray(flags))),
        lbvh.propagate_leaf_flags(tree, torch.from_numpy(flags)).numpy())


@pytest.mark.parametrize("eps", [1e-5, 0.5])
def test_cell_coords_resolution_cap(eps):
    # eps=1e-5 overflows the 2**16 cells/dim cap: the grid degrades and
    # dense_valid turns False, exactly as in the reference
    pts = pointclouds.load("portotaxi_like", 600)
    c, valid = grid._cell_coords(torch.from_numpy(pts), eps)
    jc, jvalid = jgrid._cell_coords(jnp.asarray(pts), eps)
    assert valid == jvalid == (eps > 1e-4)
    np.testing.assert_array_equal(np.asarray(jc).astype(np.int64), c.numpy())


def test_clz_matches_reference_delta():
    # the 32-bit clz written in int64 arithmetic, with the index tie-break
    rng = np.random.default_rng(3)
    codes = np.sort(rng.integers(0, 2**32, 300, dtype=np.uint64)
                    ).astype(np.uint32)
    codes[50:60] = codes[50]                     # equal codes: tie-break
    codes[0], codes[-1] = 0, 2**32 - 1
    jdelta = jlbvh._delta_fn(jnp.asarray(codes))
    delta = lbvh._delta_fn(torch.from_numpy(codes.astype(np.int64)))
    i = rng.integers(0, 300, 2000)
    j = rng.integers(-3, 303, 2000)
    ji, jj = jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(jdelta(ji, jj)),
        delta(torch.from_numpy(i), torch.from_numpy(j)).numpy())


def test_all_duplicate_points_tree():
    # every code equal: the topology rests on the index tie-break alone
    pts = np.zeros((9, 3), np.float32)
    ref = jgrid.build_segments_fdbscan(jnp.asarray(pts))
    port = grid.build_segments_fdbscan(torch.from_numpy(pts))
    _assert_fields_equal(ref, port)
    _assert_fields_equal(
        jlbvh.build_tree(ref.codes, ref.prim_lo, ref.prim_hi),
        lbvh.build_tree(port.codes, port.prim_lo, port.prim_hi))


def test_jump_to_fixpoint_matches_reference():
    rng = np.random.default_rng(7)
    labels = np.arange(500, dtype=np.int32)
    for i in range(1, 500):                     # a decreasing pointer forest
        labels[i] = rng.integers(0, i + 1)
    np.testing.assert_array_equal(
        np.asarray(junionfind.jump_to_fixpoint(jnp.asarray(labels))),
        unionfind.jump_to_fixpoint(torch.from_numpy(labels)).numpy())
