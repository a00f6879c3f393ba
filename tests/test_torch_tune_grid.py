"""The port's tuner over the reference's whole candidate grid
(``tune.TUNE_LANE_TILES`` x ``tune.TUNE_UNROLLS``, the cases of the
reference's ``tests/test_tune.py``), end to end against the golden file:
every (lane tile, unroll), with reordering on (Morton first pass,
calibrated depth sweeps), gives the golden labels, core mask, cluster and
sweep counts, and the walk's uncapped counts at every lane tile the golden
counts. Port only: the golden file is the reference's output.

Tolerance: zero.
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

from repro_torch.core import fdbscan, grid, lbvh, traversal, tune  # noqa
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.kernels import traverse as kt  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = np.load(os.path.join(HERE, "golden", "golden.npz"))

# the portotaxi golden scenario (tests/golden/make_golden.py)
DSET, N, EPS, MINPTS = "portotaxi_like", 800, 0.02, 5


@pytest.fixture(scope="module")
def index():
    segs = grid.build_segments_fdbscan(
        torch.from_numpy(pointclouds.load(DSET, N)))
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    return segs, tree


def _forced(lane_tile, unroll):
    """A TuneState running every phase at one (lane_tile, unroll), with
    reordering on (the reference's test_tune._forced)."""
    fp = tune.PhaseConfig("pallas", lane_tile, unroll, "morton")
    sw = tune.PhaseConfig("pallas", lane_tile, unroll, "depth")
    bd = tune.PhaseConfig("pallas", lane_tile, unroll, "none")
    return tune.TuneState(tune.TunedConfig(
        first_pass=fp, sweep=sw, border=bd,
        min_lanes=0, border_min_frac=0.0, source="grid"))


@pytest.mark.parametrize("unroll", tune.TUNE_UNROLLS)
@pytest.mark.parametrize("lane_tile", tune.TUNE_LANE_TILES)
def test_config_grid_bit_identical(index, lane_tile, unroll):
    # the full candidate grid, end to end, byte-equal to the goldens with
    # reordering on (morton first pass, calibrated depth sweeps)
    segs, tree = index
    st = _forced(lane_tile, unroll)
    res = fdbscan.cluster_from_index(segs, tree, EPS, MINPTS,
                                     backend="pallas-tree", tune=st)
    g = f"{DSET}/fdbscan"
    np.testing.assert_array_equal(res.labels.numpy(), GOLDEN[f"{g}/labels"])
    np.testing.assert_array_equal(res.core_mask.numpy(), GOLDEN[f"{g}/core"])
    assert res.n_clusters == int(GOLDEN[f"{g}/n_clusters"])
    assert res.n_sweeps == int(GOLDEN[f"{g}/n_sweeps"])
    assert st.depth_rank is not None


@pytest.mark.parametrize("lane_tile", tune.TUNE_LANE_TILES)
def test_config_grid_counts_bit_identical(index, lane_tile):
    # exact uncapped neighbor counts at every lane tile, Morton order
    segs, tree = index
    tr = kt.traverse(tree, segs, traversal.intersects(traversal.sphere(EPS)),
                     traversal.CountVisitor(cap=traversal.INT_MAX),
                     lane_tile=lane_tile, reorder="morton")
    counts = np.zeros(N, np.int64)
    counts[segs.order.numpy()] = tr.acc.numpy()
    np.testing.assert_array_equal(counts, GOLDEN[f"{DSET}/counts"])
