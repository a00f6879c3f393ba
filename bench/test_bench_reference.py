"""The plain reference against brute-force DBSCAN, its float32 arithmetic
against exact arithmetic, and its checks against planted faults (CPU)."""
import fractions
import itertools

import numpy as np
import pytest
import torch

from bench.reference import dbscan_ref as R
from bench.reference import stream_ref as S

torch.set_num_threads(1)


def brute(pts: np.ndarray, eps2: float, min_pts: int):
    """DBSCAN by every pair, in float64 (exact on lattice points):
    (core, component of each core point as its smallest index, and for
    each point the set of components of its core neighbours)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    p = pts.astype(np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    adj = d2 <= eps2
    core = adj.sum(1) >= min_pts
    cc = np.nonzero(core)[0]
    _, lab = connected_components(csr_matrix(adj[np.ix_(cc, cc)]),
                                  directed=False)
    comp = np.full(len(p), -1)
    for c in np.unique(lab):
        members = cc[lab == c]
        comp[members] = members.min()
    nb = [set(comp[cc[adj[i, cc]]]) for i in range(len(p))]
    return core, comp, nb


def lattice(n, d, side, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, side, size=(n, d)).astype(np.float32)


CASES = [  # (d, points, lattice side, eps, min_pts)
    (2, 600, 48, 2.0, 4),
    (2, 500, 40, 5 ** 0.5, 6),
    (3, 700, 16, 2 ** 0.5, 5),
    (3, 400, 12, 3 ** 0.5, 2),
]


@pytest.mark.parametrize("case", CASES)
def test_solve_matches_brute_force_dbscan(case):
    d, n, side, eps, m = case
    pts = lattice(n, d, side, seed=n + d)
    core, comp, nb = brute(pts, R.radius2(eps), m)
    labels, rcore, nc = R.solve(torch.from_numpy(pts), eps, m,
                                block=4096)
    labels = labels.numpy()
    assert np.array_equal(rcore.numpy(), core)
    # the same partition of the core points
    pairs = set(zip(comp[core], labels[core]))
    assert len(pairs) == len(set(comp[core])) == len(set(labels[core])) \
        == nc
    lab_of = dict(pairs)
    for i in np.nonzero(~core)[0]:
        if nb[i]:
            assert labels[i] in {lab_of[c] for c in nb[i]}
        else:
            assert labels[i] == -1


@pytest.mark.parametrize("case", CASES)
def test_check_passes_brute_force_and_catches_faults(case):
    d, n, side, eps, m = case
    pts = lattice(n, d, side, seed=n + d)
    core, comp, nb = brute(pts, R.radius2(eps), m)
    uniq = np.unique(comp[core])
    labels = np.full(n, -1)
    labels[core] = np.searchsorted(uniq, comp[core])
    for i in np.nonzero(~core)[0]:
        if nb[i]:
            labels[i] = min(np.searchsorted(uniq, c) for c in nb[i])
    t = torch.from_numpy(pts)

    def check(lab, cm, k):
        out = R.check_clustering(t, eps, m, torch.from_numpy(lab),
                                 torch.from_numpy(cm), k, block=2048)
        return {k: v for k, v in out.items() if not k.startswith("_")}

    assert not any(check(labels, core, len(uniq)).values())
    # a core bit flipped
    bad = core.copy()
    bad[np.nonzero(core)[0][0]] = False
    assert check(labels, bad, len(uniq))["core_mismatch"] == 1
    # a cluster split: one core point of a cluster of two or more moved
    big = [c for c in uniq if (comp == c).sum() > 1]
    if big:
        i = np.nonzero(comp == big[0])[0][-1]
        lab = labels.copy()
        lab[i] = len(uniq)
        assert check(lab, core, len(uniq) + 1)["clusters_split"] >= 1
    # two clusters merged
    if len(uniq) > 1:
        lab = labels.copy()
        lab[lab == 1] = 0
        lab[lab > 1] -= 1
        got = check(lab, core, len(uniq) - 1)
        assert got["clusters_merged"] == 1
    # a border point sent to noise, a noise point given a label
    border = [i for i in np.nonzero(~core)[0] if nb[i]]
    noise = [i for i in np.nonzero(~core)[0] if not nb[i]]
    if border:
        lab = labels.copy()
        lab[border[0]] = -1
        assert check(lab, core, len(uniq))["border_errors"] == 1
    if noise:
        lab = labels.copy()
        lab[noise[0]] = 0
        assert check(lab, core, len(uniq))["border_errors"] == 1
    # a label out of range
    lab = labels.copy()
    assert check(lab, core, len(uniq) + 2)["label_errors"] >= 1


def test_query_answers_match_brute_force():
    pts = lattice(500, 2, 40, seed=3)
    probes = lattice(200, 2, 44, seed=4) - 2
    eps, m = 2.0, 5
    t, tp = torch.from_numpy(pts), torch.from_numpy(probes)
    core, comp, _ = brute(pts, R.radius2(eps), m)
    gids = torch.arange(500) * 3 + 7          # insert ids, ascending
    comps = R.components(t, torch.from_numpy(core), eps, [("fma",)])
    labels, counts, wbc = S.answer_queries(t, gids, torch.from_numpy(core),
                                           comps[0], tp, eps, m, "fma")
    d2 = ((probes[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    adj = d2 <= eps * eps
    assert np.array_equal(counts.numpy(), np.minimum(adj.sum(1), m))
    rep = {c: int(gids[c]) for c in set(comp[core])}
    for q in range(len(probes)):
        reps = [rep[comp[j]] for j in np.nonzero(adj[q] & core)[0]]
        assert labels[q] == (min(reps) if reps else -1)
    got = S.check_queries(t, gids, torch.from_numpy(core), comps, tp,
                          labels, counts, wbc, eps, m, "fma")
    assert not any(got.values())
    bad = labels.clone()
    bad[int(torch.nonzero(bad >= 0)[0])] += 1
    assert S.check_queries(t, gids, torch.from_numpy(core), comps, tp, bad,
                           counts, wbc, eps, m,
                           "fma")["query_label_errors"] == 1
    cs, cl = S.brute_counts(tp, t, eps, m, "fma")
    assert torch.equal(cs, counts) and torch.equal(cl, counts)


def _exact(x) -> fractions.Fraction:
    return fractions.Fraction(float(x))


def test_fma32_is_correctly_rounded():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32) * np.float32(3e-3)
    b = rng.standard_normal(4000).astype(np.float32) * np.float32(3e-3)
    c = np.abs(rng.standard_normal(4000)).astype(np.float32) * np.float32(
        1e-5)
    got = R.fma32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = _exact(x) * _exact(y) + _exact(z)
        r = np.float32(float(exact))      # nearest float32 of the exact
        lo, hi = np.nextafter(r, np.float32(-1)), np.nextafter(r,
                                                               np.float32(1))
        # the nearest of r and its neighbours to the exact value
        best = min((r, lo, hi), key=lambda v: abs(_exact(v) - exact))
        assert g == best


def test_roundings_of_a_squared_distance():
    rng = np.random.default_rng(1)
    diff = rng.standard_normal((2000, 3)).astype(np.float32)
    t = torch.from_numpy(diff)
    un = R.dist2(t, "unfused").numpy()
    want = diff[:, 0] * diff[:, 0]
    for k in (1, 2):
        want = (want + diff[:, k] * diff[:, k]).astype(np.float32)
    assert np.array_equal(un, want)
    fm = R.dist2(t, "fma").numpy()
    assert (fm != un).any() and np.allclose(fm, un, rtol=1e-6)
    tf = R.to_tf32(t).numpy().view(np.int32)
    assert not (tf & 0x1FFF).any()
    assert np.allclose(R.to_tf32(t).numpy(), diff, rtol=2 ** -11)
    strict, loose = R.Rounding.of(("fma", "unfused")).within(
        t, float(np.median(fm)))
    assert (strict <= loose).all()


def test_expand_pairs_covers_every_range_once():
    owner = torch.tensor([0, 1, 2, 3])
    start = torch.tensor([5, 0, 9, 2])
    length = torch.tensor([3, 0, 4, 1])
    got = []
    for o, j in R.expand_pairs(owner, start, length, block=3):
        got += list(zip(o.tolist(), j.tolist()))
    want = [(o, s + k) for o, s, ln in zip(owner.tolist(), start.tolist(),
                                           length.tolist())
            for k in range(ln)]
    assert sorted(got) == sorted(want)


def test_grid_neighbours_hold_every_pair_within_eps():
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.uniform(0, 1, (800, 3)).astype(np.float32))
    eps = 0.09
    seen = set()
    for qi, j, s, _ in R.neighbours_of(pts, pts, eps, R.Rounding.of("fma"),
                                       block=5000):
        seen |= {(a, b) for a, b, h in zip(qi.tolist(), j.tolist(),
                                          s.tolist()) if h}
    d2 = R.dist2(pts[:, None, :] - pts[None, :, :], "fma") <= R.radius2(eps)
    want = {(a, b) for a, b in itertools.product(range(800), repeat=2)
            if d2[a, b]}
    assert seen == want
