"""The frozen NGSIM surrogate, ``bench/generators/trajectories_2d.py``: its
catalog is the original's lane geometry and its points follow the
original's statistics at small n (CPU).

The original is ``repro_torch.data.pointclouds.trajectories_2d``; the test
imports it to compare, the benchmark never does."""
import numpy as np
import pytest
import torch

from bench import data

torch.set_num_threads(1)

pointclouds = pytest.importorskip("repro_torch.data.pointclouds")

NGSIM = {"n": 60003, "generator": {"name": "trajectories_2d", "params": {
    "n_lanes": 6}}}


def _lane_residuals(pts, cat, lane):
    """Each point's offset across lane ``lane`` of the catalog at its x."""
    x, y = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    return y - (cat["amplitude"] * np.sin(cat["omega"] * x
                                          + cat["phases"][lane])
                + cat["offsets"][lane])


def test_lane_catalog_is_the_originals_geometry():
    # the original draws nothing but its points from its seed: each of its
    # lanes (a block of n // 6 points, in lane order) lies on the catalog's
    # curve for that lane, spread by the catalog's sigma (widened by the
    # curve's slope times the spread along x), and on no other lane's
    n = NGSIM["n"]
    cat = data.catalog(NGSIM)
    theirs = pointclouds.trajectories_2d(n)
    per = n // 6
    sigma = cat["sigma"]
    slope = cat["amplitude"] * cat["omega"]
    for lane in range(6):
        block = theirs[lane * per:(lane + 1) * per]
        r = _lane_residuals(block, cat, lane)
        assert abs(r.mean()) < 0.05 * sigma
        assert sigma <= r.std() <= sigma * np.sqrt(1 + slope ** 2) * 1.02
        other = _lane_residuals(block, cat, (lane + 1) % 6)
        assert np.abs(other).mean() > 20 * sigma
    rest = theirs[6 * per:]
    assert len(rest) == n - 6 * per == 3
    assert (rest >= 0).all() and (rest < cat["rest_box"]).all()


def test_lane_points_follow_the_originals_statistics():
    n = NGSIM["n"]
    cat = data.catalog(NGSIM)
    ours = data.draw(NGSIM, cat, n, data.derive_seed(9), "cpu").numpy()
    theirs = pointclouds.trajectories_2d(n)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == theirs.shape
    qs = np.linspace(0.05, 0.95, 19)
    for k, tol in ((0, 0.01), (1, 0.003)):
        assert np.abs(np.quantile(ours[:, k], qs)
                      - np.quantile(theirs[:, k], qs)).max() < tol
    # lane by lane, in the original's order: the spread across the lane
    per = n // 6
    for lane in range(6):
        sl = slice(lane * per, (lane + 1) * per)
        r_o = _lane_residuals(ours[sl], cat, lane)
        r_t = _lane_residuals(theirs[sl], cat, lane)
        assert abs(r_o.mean() - r_t.mean()) < 0.05 * cat["sigma"]
        assert abs(r_o.std() / r_t.std() - 1) < 0.03
        assert np.abs(np.quantile(ours[sl, 0], qs) - qs).max() < 0.025
    assert (ours[6 * per:] >= 0).all() and (ours[6 * per:]
                                            < cat["rest_box"]).all()
