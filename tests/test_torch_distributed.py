"""The port's distributed path on the CPU: the sharded backend against
the 8 golden ``*/sharded/*`` entries, a shard made only of
sentinels and the ``n_loc < 2`` fallback against the live reference, the
slab geometry (``shard_bounds``, ``halo_mask``) against the reference's,
the dispatch rules for ``mesh=``/``axis=``, the mesh factories, and the
roofline terms and collective wire bytes against the reference's
``repro.launch.roofline``.

The live reference runs in one subprocess under 8 forced host devices
(``test_torch_ring_tree.JaxOracle``). Tolerance: zero (byte-equal).
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
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.distributed import ring_dbscan as rd, sharding  # noqa: E402
from repro_torch.launch import mesh as lmesh, roofline  # noqa: E402

from conftest import separated_points  # noqa: E402
from test_torch_ring_tree import (JaxOracle, assert_same,  # noqa: E402
                                  assert_same_evals, run_programs,
                                  sharded_case)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = np.load(os.path.join(HERE, "golden", "golden.npz"))

# 20 points on 8 shards: 3 rows a shard, the last shard all sentinels
TINY = ("tiny", separated_points(20, 2, eps=0.3, seed=6), 0.3, 3)
# 7 points on 8 shards: one row a shard, too few for a tree
FALLBACK = ("fallback", separated_points(7, 2, eps=0.5, seed=7), 0.5, 2)
# tests/golden/make_golden.py's sharded scenarios
GOLDEN_CASES = [("portotaxi_like", 800, 0.02, 5), ("hacc_like", 800, 0.05, 5)]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    cases = [sharded_case(TINY[0], TINY[2], TINY[3]),
             {"kind": "fallback", "name": FALLBACK[0], "eps": FALLBACK[2],
              "min_pts": FALLBACK[3], "ndev": 8}]
    points = {TINY[0]: TINY[1], FALLBACK[0]: FALLBACK[1]}
    o = JaxOracle(str(tmp_path_factory.mktemp("oracle")), cases, points)
    yield o
    o.close()


@pytest.mark.parametrize("dset,n,eps,mp", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_sharded_backend_matches_golden(dset, n, eps, mp):
    res = repro_torch.dbscan(pointclouds.load(dset, n), eps, mp,
                             algorithm="sharded",
                             mesh=sharding.LocalMesh(8), device="cpu")
    assert res.backend == "sharded"
    np.testing.assert_array_equal(res.labels.numpy(),
                                  GOLDEN[f"{dset}/sharded/labels"])
    np.testing.assert_array_equal(res.core_mask.numpy(),
                                  GOLDEN[f"{dset}/sharded/core"])
    assert res.n_clusters == int(GOLDEN[f"{dset}/sharded/n_clusters"])
    assert res.n_sweeps == int(GOLDEN[f"{dset}/sharded/n_sweeps"])


def _slabs():
    """Sentinel-padded slabs: a shard with real rows then padding, one of
    padding only, and one with a degenerate axis."""
    rng = np.random.default_rng(11)
    out = []
    for d in (2, 3):
        real = rng.uniform(0.2, 0.7, (10, d)).astype(np.float32)
        pad = np.full((6, d), 1e30, np.float32)
        slab = np.concatenate([real, pad])
        out.append((slab, np.arange(16) < 10))
        out.append((np.full((5, d), 1e30, np.float32), np.zeros(5, bool)))
        flat = real.copy()
        flat[:, 0] = 0.25
        out.append((flat, np.ones(10, bool)))
    return out


@pytest.mark.parametrize("k", range(6))
def test_shard_bounds_and_halo_mask_match_reference(k):
    slab, valid = _slabs()[k]
    lo, hi = sharding.shard_bounds(torch.from_numpy(slab),
                                   torch.from_numpy(valid))
    jlo, jhi = jsharding.shard_bounds(jnp.asarray(slab), jnp.asarray(valid))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    # queries around the eps-dilated box, on its edge to the last ulp,
    # and sentinel rows
    eps = np.float32(0.05)
    d = slab.shape[1]
    rng = np.random.default_rng(k)
    edge = np.asarray(jhi, np.float32) + eps
    near = np.stack([np.nextafter(edge, np.float32(np.inf)), edge,
                     np.nextafter(edge, np.float32(-np.inf))])
    q = np.concatenate([rng.uniform(-0.2, 1.2, (64, d)).astype(np.float32),
                        near, np.full((2, d), 1e30, np.float32)])
    for e in (eps, 0.0, 0.3):
        got = sharding.halo_mask(torch.from_numpy(q), lo, hi, float(e))
        want = jsharding.halo_mask(jnp.asarray(q), jlo, jhi, float(e))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dispatch_mesh_rules():
    pts = separated_points(120, 2, eps=0.1, seed=4)
    mesh = sharding.LocalMesh(4)
    for algo in ("stream", "tiled", "fdbscan", "fdbscan-densebox",
                 "pallas-tree"):
        with pytest.raises(ValueError, match="mesh"):
            repro_torch.dbscan(pts, 0.1, 5, algorithm=algo, mesh=mesh,
                               device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            dispatch.plan(pts, 0.1, 5, algorithm=algo, mesh=mesh,
                          device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        dispatch.plan(pts, 0.1, 5, algorithm="sharded", mesh=mesh,
                      axis="model", device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        rd.tree_dbscan_sharded(pts, 0.1, 5, mesh=mesh, axis="model",
                               device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        rd.tree_dbscan_sharded(pts, -0.1, 5, mesh=mesh, device="cpu")
    # auto ignores a mesh without the axis, and a one-shard mesh
    for m, ax in ((mesh, "model"), (sharding.LocalMesh(1), "data")):
        p = dispatch.plan(pts, 0.1, 5, mesh=m, axis=ax, device="cpu")
        assert p.backend != "sharded"
    p = dispatch.plan(pts, 0.1, 5, mesh=mesh, device="cpu")
    assert p.backend == "sharded" and p.stats["ndev"] == 4
    assert p.stats["axis"] == "data" and p.device.type == "cpu"
    # an explicit sharded plan without a mesh takes the default mesh
    p = dispatch.plan(pts, 0.1, 5, algorithm="sharded", device="cpu")
    assert p.stats["ndev"] == 1 and p.stats["mesh"] is None
    with pytest.raises(NotImplementedError, match="DBSCAN"):
        repro_torch.dbscan(pts, 0.1, 5, algorithm="sharded", mesh=mesh,
                           star=True, device="cpu")
    with pytest.raises(ValueError, match="frontier"):
        repro_torch.dbscan(pts, 0.1, 5, algorithm="sharded", mesh=mesh,
                           frontier=False, device="cpu")
    # the card has no plain tile: the difference form is for CPU tensors
    with pytest.raises(ValueError, match="use_pallas"):
        rd.ring_dbscan(pts, 0.1, 5, mesh=mesh, use_pallas=False,
                       device="cuda")
    # a named mesh axis other than "data"
    named = sharding.LocalMesh(3, "shards")
    res = repro_torch.dbscan(pts, 0.1, 5, mesh=named, axis="shards",
                             device="cpu")
    ref = repro_torch.dbscan(pts, 0.1, 5, algorithm="fdbscan", device="cpu")
    assert res.backend == "sharded"
    np.testing.assert_array_equal(res.core_mask.numpy(),
                                  ref.core_mask.numpy())


def test_mesh_factories_and_constants():
    m = lmesh.make_host_mesh()           # no process group: one shard
    assert isinstance(m, sharding.LocalMesh)
    assert (m.axis_names, m.axis_sizes) == (("data", "model"), (1, 1))
    with pytest.raises(ValueError):
        lmesh.make_host_mesh(model=2)
    loc = lmesh.make_local_mesh(8)
    assert loc.held("data") == list(range(8)) and loc.size == 8
    prod = lmesh.make_production_mesh()
    assert (prod.axis_names, prod.axis_sizes, prod.size) == (
        ("data", "model"), (16, 16), 256)
    multi = lmesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert (lmesh.PEAK_FLOPS_BF16, lmesh.PEAK_FLOPS_FP32, lmesh.HBM_BW,
            lmesh.NVLINK_BW, lmesh.HBM_PER_CHIP) == (989e12, 67e12, 3.35e12,
                                                     450e9, 80 * 10**9)


# One HLO line a collective kind, as the reference parses them, and the
# record a mesh keeps of the same collective.
HLO = [
    ("all-reduce", "%ar = s64[] all-reduce(s64[] %x), "
     "replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add", 8, 8),
    ("all-gather", "%ag = s32[1600]{0} all-gather(s32[200]{0} %x), "
     "replica_groups=[1,8]<=[8], dimensions={0}", 6400, 8),
    ("reduce-scatter", "%rs = f32[100]{0} reduce-scatter(f32[400]{0} %x), "
     "replica_groups={{0,1,2,3}}, dimensions={0}", 400, 4),
    ("all-to-all", "%aa = f32[64,8]{1,0} all-to-all(f32[64,8]{1,0} %x), "
     "replica_groups={{0,1}}, dimensions={0}", 2048, 2),
    ("collective-permute", "%cp = f32[200,3]{1,0} collective-permute("
     "f32[200,3]{1,0} %x), source_target_pairs={{0,1},{1,2},{2,0}}",
     2400, 3),
]


@pytest.mark.parametrize("kind,line,nbytes,group", HLO,
                         ids=[h[0] for h in HLO])
def test_collective_wire_bytes_match_reference(kind, line, nbytes, group):
    want = jroofline.collective_wire_bytes(line, 8)
    got = roofline.collective_wire_bytes({(kind, nbytes, group): 1}, 8)
    assert got == want
    # counted as often as it ran
    twice = roofline.collective_wire_bytes({(kind, nbytes, group): 2}, 8)
    assert twice["total"] == 2 * want["total"]
    assert twice["counts"][kind] == 2


def test_roofline_terms_match_reference():
    wire = roofline.collective_wire_bytes(
        {("all-gather", 6400, 8): 1, ("collective-permute", 2400, 8): 3}, 8)
    for cost in ({"flops": 1e12, "bytes accessed": 1e9},
                 {"flops": 1e6, "bytes accessed": 4e12}, {},
                 {"flops": 3.0, "bytes accessed": 5.0}):
        for w in (wire, {"total": 0}, {"total": 10**12}):
            kw = dict(peak_flops=lmesh.PEAK_FLOPS_FP32, hbm_bw=lmesh.HBM_BW,
                      ici_bw=lmesh.NVLINK_BW)
            assert roofline.roofline_terms(cost, w, **kw) == \
                jroofline.roofline_terms(cost, w, **kw)


def test_local_mesh_records_its_collectives():
    pts = separated_points(200, 2, eps=0.1, seed=9)
    mesh = sharding.LocalMesh(4)
    res = rd.tree_dbscan_sharded(pts, 0.1, 4, mesh=mesh, device="cpu")
    kinds = {k for k, _, _ in mesh.collectives}
    assert kinds == {"collective-permute", "all-gather", "all-reduce"}
    assert {g for _, _, g in mesh.collectives} == {4}
    # a rotation moves four blocks a step: points, on-flags, acc, evals
    permutes = sum(c for (k, _, _), c in mesh.collectives.items()
                   if k == "collective-permute")
    assert permutes == 4 * 4 * (res.n_sweeps + 2)
    # every all-gather is a whole (n_pad,) table of int32 labels or the
    # (n_pad,) core flags of the result
    assert {b for k, b, _ in mesh.collectives if k == "all-gather"} == {
        200 * 4, 200}
    wire = roofline.collective_wire_bytes(mesh.collectives, 4)
    assert wire["total"] == sum(v for k, v in wire.items()
                                if k not in ("total", "counts"))


# The cases held against the live reference come last, so that the
# oracle's subprocess computes while the tests above run.

def test_sentinel_only_shard_matches_live_reference(oracle):
    """n small on a wide mesh: the last shard holds only sentinel rows
    (1e30). Its tree's boxes and the walks' squares overflow to inf; every
    comparison stays false for them (the tiles at this shape:
    ``test_torch_ring.py``)."""
    name, pts, eps, mp = TINY
    res, evals = run_programs(pts, eps, mp)
    want = oracle.get(name)
    assert_same(res, want, name)
    assert_same_evals(evals, want, name)
    assert not evals[:, 21:].any()      # sentinel lanes walk nothing


def test_fallback_to_ring_below_two_rows_a_shard(oracle):
    name, pts, eps, mp = FALLBACK
    res, st = rd.tree_dbscan_sharded(pts, eps, mp,
                                     mesh=sharding.LocalMesh(8),
                                     with_stats=True, device="cpu")
    want = oracle.get(name)
    assert_same(res, want, name)
    assert res.backend == "ring"
    assert [st["distance_evals"], st["ring_distance_evals"], st["ndev"],
            st["n_pad"], st["n_sweeps"]] == want[name + "/stats"].tolist()
