"""The program against the plain reference on the frozen NGSIM generator
(CPU, small n): labels and core mask exact, in the DenseBox regime.

At 6,000 points the lane strips are thinner than a cell, so eps = 0.01
and min_pts 4, 6 and 7 stand in for the configuration's 0.001 and
50 to 500: the plans' dense cells hold at least 60% of the points at every
min_pts, and at 7 at least 30% of the points are loose, as at full size
(98% to 62% dense). The shares are the program's own counters
(``dbscan_dense_points_total`` over ``dbscan_points_total``)."""
import pytest
import torch

from bench import data
from bench.loops import CLUSTER_CHECKS
from bench.reference import dbscan_ref

torch.set_num_threads(1)

repro_torch = pytest.importorskip("repro_torch")
from repro_torch import obs  # noqa: E402
from repro_torch.obs import names  # noqa: E402

N, EPS = 6000, 0.01
MIN_PTS = (4, 6, 7)
CFG = {"n": N, "generator": {"name": "trajectories_2d",
                             "params": {"n_lanes": 6}}}
_draws: dict = {}


def ngsim(seed: int) -> torch.Tensor:
    if seed not in _draws:
        _draws[seed] = data.draw(CFG, data.catalog(CFG), N,
                                 data.derive_seed(seed), "cpu")
    return _draws[seed]


def counter(snap: dict, name: str) -> float:
    return sum(s["value"] for m in snap["metrics"] if m["name"] == name
               for s in m["series"])


@pytest.mark.parametrize("min_pts", MIN_PTS)
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 32 + 77, 20210309])
def test_program_is_exact_on_lane_strips(seed, min_pts):
    pts = ngsim(seed)
    with obs.instrumented() as (reg, _):
        res = repro_torch.dbscan(pts, EPS, min_pts, device="cpu")
        snap = reg.snapshot()
    assert res.backend == "fdbscan-densebox"
    share = (counter(snap, names.DBSCAN_DENSE_POINTS)
             / counter(snap, names.DBSCAN_POINTS))
    assert share >= 0.6
    if min_pts == max(MIN_PTS):
        assert share <= 0.7
    got = dbscan_ref.check_clustering(pts, EPS, min_pts, res.labels,
                                      res.core_mask, res.n_clusters)
    assert {k: got[k] for k in CLUSTER_CHECKS} == dict.fromkeys(
        CLUSTER_CHECKS, 0), got["_ref"]
    # the loose lanes' distance tests are a part of all the walks' tests
    loose = counter(snap, names.TRAVERSAL_LOOSE_EVALS)
    assert 0 < loose <= counter(snap, "traversal_evals_total")
