"""Shared fixtures + the ``fast``, ``fault`` and ``cuda`` markers.

Tier-1 iteration: ``pytest -m fast`` (or ``make test-fast``) runs the quick
algorithmic subset — core DBSCAN correctness, the traversal engine, the
dispatcher, morton/LBVH — in seconds instead of the ~6-minute full suite.
Modules listed in ``FAST_MODULES`` are auto-marked; individual tests can
also opt in with ``@pytest.mark.fast``.
"""
import numpy as np
import pytest

FAST_MODULES = {
    "test_morton",
    "test_lbvh",
    "test_dbscan",
    "test_traversal_fused",
    "test_dispatch",
    "test_neighbors",
    "test_pallas_tree",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "fast: quick tier-1 subset (run with `pytest -m fast`)")
    config.addinivalue_line(
        "markers", "fault: subprocess kill-based crash/recovery tests for "
        "the streaming durability layer (run with `pytest -m fault`)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one; run on "
        "the card with `pytest -m cuda tests`)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in FAST_MODULES:
            item.add_marker(pytest.mark.fast)


def separated_points(n: int, d: int, eps: float, seed: int,
                     band: float = 2e-3) -> np.ndarray:
    """Random points with no pair within a relative band of eps^2.

    DBSCAN is discontinuous at dist == eps: different (equally valid)
    float summation orders flip pairs sitting exactly on the boundary.
    Tests that compare two backends exactly use boundary-separated data;
    boundary behaviour itself is covered by the integer-grid property tests
    (where d2 is exact).
    """
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    e2 = eps * eps
    while True:
        d2 = ((pts[:, None, :].astype(np.float64)
               - pts[None, :, :].astype(np.float64)) ** 2).sum(-1)
        offending = np.abs(d2 - e2) < band * e2
        np.fill_diagonal(offending, False)
        bad = np.unique(np.nonzero(offending)[0])
        if len(bad) == 0:
            return pts
        repl = rng.uniform(0, 1, size=(len(bad), d)).astype(np.float32)
        pts[bad] = repl


@pytest.fixture
def rng():
    return np.random.default_rng(0)
