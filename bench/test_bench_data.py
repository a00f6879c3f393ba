"""The frozen surrogate generators: their catalogs are the originals' first
draws, their particles follow the originals' statistics at small n, and a
seed fixes a draw (CPU).

The originals are ``repro_torch.data.pointclouds.halos_3d`` and
``taxi_2d``; the test imports them to compare, the benchmark never does."""
import numpy as np
import pytest
import torch

from bench import data

torch.set_num_threads(1)

pointclouds = pytest.importorskip("repro_torch.data.pointclouds")

HACC = {"n": 40000, "generator": {"name": "halos_3d", "params": {
    "n_halos": 50, "background_frac": 0.5, "seed": 3}}}
PORTO = {"n": 40000, "generator": {"name": "taxi_2d", "params": {
    "k": 30, "seed": 2}}}


def test_catalogs_are_the_originals_first_draws():
    rng = np.random.default_rng(3)
    cat = data.catalog(HACC)
    assert np.array_equal(cat["centers"], rng.uniform(0, 1, size=(50, 3)))
    mass = rng.pareto(1.2, size=50) + 0.05
    assert np.allclose(cat["weights"], mass / mass.sum())
    cat = data.catalog(PORTO)
    rng = np.random.default_rng(2)
    assert np.array_equal(cat["centers"], rng.uniform(0, 1, size=(30, 2)))
    w = rng.pareto(1.5, size=30) + 0.1
    w /= w.sum()
    rng.choice(30, size=40000, p=w)
    assert np.array_equal(cat["scales"], rng.uniform(0.002, 0.05, size=30))


def _nearest(pts, centers):
    d = np.linalg.norm(pts[:, None, :].astype(np.float64)
                       - centers[None], axis=-1)
    return d.min(1), d.argmin(1)


@pytest.mark.parametrize("cfg,original", [
    (HACC, lambda n: pointclouds.halos_3d(n)),
    (PORTO, lambda n: pointclouds.taxi_2d(n))])
def test_particles_follow_the_originals_statistics(cfg, original):
    n = cfg["n"]
    cat = data.catalog(cfg)
    ours = data.draw(cfg, cat, n, data.derive_seed(9), "cpu").numpy()
    theirs = original(n)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == theirs.shape
    qs = np.linspace(0.05, 0.95, 19)
    for k in range(ours.shape[1]):
        assert np.abs(np.quantile(ours[:, k], qs)
                      - np.quantile(theirs[:, k], qs)).max() < 0.03
    # the clumping: distance to the nearest centre, and the share of each
    # centre's points
    r_o, c_o = _nearest(ours, cat["centers"])
    r_t, c_t = _nearest(theirs, cat["centers"])
    q = np.quantile(r_o, qs) / np.quantile(r_t, qs)
    assert np.abs(q - 1).max() < 0.1
    share_o = np.bincount(c_o, minlength=len(cat["centers"])) / n
    share_t = np.bincount(c_t, minlength=len(cat["centers"])) / n
    assert np.abs(share_o - share_t).max() < 0.02


def test_a_seed_fixes_the_draw():
    cat = data.catalog(HACC)
    a = data.draw(HACC, cat, 5000, data.derive_seed(2 ** 31 + 3, 0, 1),
                  "cpu")
    b = data.draw(HACC, cat, 5000, data.derive_seed(2 ** 31 + 3, 0, 1),
                  "cpu")
    c = data.draw(HACC, cat, 5000, data.derive_seed(2 ** 31 + 3, 0, 2),
                  "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert data.derive_seed(2 ** 33, 1) != data.derive_seed(2 ** 33, 2)
    assert 0 <= data.derive_seed(2 ** 40) < 2 ** 63
