"""Tile parity: the plain versions of the tile kernels (``kernels/ref.py``,
the CPU path of ``pairwise_count``/``pairwise_minlabel``) against the JAX
Pallas tile kernels in interpret mode and the JAX plain oracles.

Tolerance: zero, with two kinds of data.
  * Against the Pallas kernels, on any data: the port computes the
    kernels' own MXU-form distance with the same float32 roundings as the
    compiled reference (the dot product is the first axis's product then
    one fused multiply-add per further axis, the norms round as
    ``kernels/ref.py: tile_sum_sq``, and eps is squared in float32), so
    counts and labels are byte-equal even for pairs at the eps boundary.
  * Against ``repro/kernels/ref.py``, on boundary-separated data only:
    that oracle uses the other form, sum((q - r)^2) against eps*eps in
    double, which can flip a pair within about one ulp of eps.
The CUDA kernels (``csrc/pairwise.cu``) repeat the plain arithmetic and are
held against it on the card by ``chip_smoke.py``.

The widths cover each rounding of the norms: the fused chain at d <= 4
and 9..32, unfused sums at 5..8, windows of 32 from d = 33 on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.kernels import pairwise as jpairwise  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core.lbvh import fma_f32  # noqa: E402
from repro_torch.kernels import pairwise, ref  # noqa: E402

from conftest import separated_points  # noqa: E402

SHAPES = [(7, 5), (130, 257), (1, 1)]
INT_MAX = 2**31 - 1
# eps per width on uniform points: about 2% of pairs within eps above d = 3
EPS = {2: 0.2, 3: 0.2, 16: 1.1, 17: 1.15, 33: 1.85, 64: 2.75}
WIDE = [16, 17, 33, 64]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("d", [2, 3, *WIDE])
@pytest.mark.parametrize("nq,nr", SHAPES)
def test_count_matches_pallas_and_oracle(nq, nr, d):
    eps = EPS[d]
    pts = separated_points(nq + nr, d, eps=eps, seed=nq + nr + d)
    q, r = pts[:nq], pts[nq:]
    out = pairwise.pairwise_count(_t(q), _t(r), eps)
    assert out.dtype == torch.int32 and out.shape == (nq,)
    np.testing.assert_array_equal(
        np.asarray(jpairwise.pairwise_count(q, r, eps)), out.numpy())
    np.testing.assert_array_equal(
        np.asarray(jref.pairwise_count_ref(q, r, eps)), out.numpy())


@pytest.mark.parametrize("d", [2, *WIDE])
@pytest.mark.parametrize("nq,nr", SHAPES)
def test_minlabel_matches_pallas_and_oracle(nq, nr, d):
    rng = np.random.default_rng(nq * 7 + nr)
    eps = EPS[d]
    pts = separated_points(nq + nr, d, eps=eps, seed=nq + 31 * nr + d - 2)
    q, r = pts[:nq], pts[nq:]
    labels = rng.integers(0, max(nr, 1), size=nr).astype(np.int32)
    mask = rng.random(nr) > 0.4
    out_l, out_c = pairwise.pairwise_minlabel(_t(q), _t(r), _t(labels),
                                              _t(mask), eps)
    for jl, jc in (jpairwise.pairwise_minlabel(q, r, labels, mask, eps),
                   jref.pairwise_minlabel_ref(q, r, jnp.asarray(labels),
                                              jnp.asarray(mask), eps)):
        np.testing.assert_array_equal(np.asarray(jl), out_l.numpy())
        np.testing.assert_array_equal(np.asarray(jc), out_c.numpy())


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_count_dtypes(dtype):
    pts = separated_points(100, 2, eps=0.25, seed=3).astype(dtype)
    out = pairwise.pairwise_count(_t(pts), _t(pts), 0.25)
    np.testing.assert_array_equal(
        np.asarray(jpairwise.pairwise_count(pts, pts, 0.25)), out.numpy())
    np.testing.assert_array_equal(
        np.asarray(jref.pairwise_count_ref(pts, pts, 0.25)), out.numpy())


@pytest.mark.parametrize("cap", [1, 3, INT_MAX])
def test_count_saturates(cap):
    pts = separated_points(150, 2, eps=0.3, seed=9)
    out = pairwise.pairwise_count(_t(pts), _t(pts), 0.3, cap=cap)
    np.testing.assert_array_equal(
        np.asarray(jpairwise.pairwise_count(pts, pts, 0.3, cap=cap)),
        out.numpy())
    assert int(out.max()) <= cap


def test_minlabel_all_masked():
    pts = separated_points(90, 2, eps=0.2, seed=11)
    out_l, out_c = pairwise.pairwise_minlabel(
        _t(pts), _t(pts), torch.arange(90, dtype=torch.int32),
        torch.zeros(90, dtype=torch.bool), 0.2)
    assert (out_l == INT_MAX).all() and (out_c == 0).all()


def _grid_points(d: int, rng):
    """300 points on a grid of step 0.1 with 1e-7 jitter, and an eps on
    one of its distance shells: 12 levels and eps 0.3 at d <= 3; above,
    the levels {0, 0.1, 0.2} and eps 0.1 * sqrt(k), k the median squared
    grid distance, so a query has about half the points within eps."""
    levels = 12 if d <= 3 else 3
    cells = rng.integers(0, levels, (300, d))
    pts = (cells * np.float32(0.1)
           + rng.uniform(-1e-7, 1e-7, (300, d))).astype(np.float32)
    if d <= 3:
        return pts, 0.3
    k = np.median(((cells[:, None] - cells[None]) ** 2).sum(-1))
    return pts, 0.1 * float(np.sqrt(k))


@pytest.mark.parametrize("d", [2, 3, 5, 8, *WIDE])
def test_boundary_pairs_match_pallas_kernels(d):
    # points on a coarse grid put many pairs at exactly eps (and at the
    # ulps around it): only identical arithmetic agrees on all of them
    rng = np.random.default_rng(d)
    pts, eps = _grid_points(d, rng)
    out = pairwise.pairwise_count(_t(pts), _t(pts), eps)
    np.testing.assert_array_equal(
        np.asarray(jpairwise.pairwise_count(pts, pts, eps)), out.numpy())
    labels = rng.permutation(300).astype(np.int32)
    mask = rng.random(300) < 0.7
    jl, jc = jpairwise.pairwise_minlabel(pts, pts, labels, mask, eps)
    out_l, out_c = pairwise.pairwise_minlabel(_t(pts), _t(pts), _t(labels),
                                              _t(mask), eps)
    np.testing.assert_array_equal(np.asarray(jl), out_l.numpy())
    np.testing.assert_array_equal(np.asarray(jc), out_c.numpy())


@pytest.mark.parametrize("d", [17, 64])
def test_tiled_dbscan_matches_reference_at_high_d(d):
    # the tiled path is the only path either package has for d not in
    # {2, 3}; auto takes it at n <= 1024
    eps, mp = {17: (1.0, 5), 64: (2.6, 5)}[d]
    pts = separated_points(600, d, eps=eps, seed=d)
    want = repro.dbscan(pts, eps, mp)
    got = repro_torch.dbscan(pts, eps, mp, device="cpu")
    assert got.backend == "tiled" and want.backend == "tiled"
    np.testing.assert_array_equal(np.asarray(want.labels), got.labels.numpy())
    np.testing.assert_array_equal(np.asarray(want.core_mask),
                                  got.core_mask.numpy())
    assert got.n_clusters == want.n_clusters > 1


@pytest.mark.parametrize("d", [1, 4, 5, 8, 9, 32, 33, 48, 63, 65, 97])
def test_tile_norm_windows_cover_every_axis_once(d):
    wins = ref.norm_windows(d)
    assert [a for lo, hi in wins for a in range(lo, hi)] == list(range(d))
    assert all(0 < hi - lo <= ref.WINDOW for lo, hi in wins)
    assert len(wins) == -(-d // ref.WINDOW)


@pytest.mark.parametrize("nq,nr,d,want", [
    (1000, 1000, 2, 4),         # the tiled path: 4,000 warps
    (1000, 1000, 17, 2),        # chunked body: fewer, fuller warps
    (16384, 16384, 3, 1),       # enough queries to fill the card alone
    (64, 20000, 2, 8),          # few queries, many references
    (7, 5, 2, 1),               # one warp's threads cover the references
])
def test_warps_per_query(nq, nr, d, want):
    assert pairwise.warps_per_query(nq, nr, d) == want
    assert want in pairwise.SPLITS


def test_fma_is_correctly_rounded():
    # a * b + c = 1 + 2**-11 + 2**-24 + 2**-70: one rounding gives
    # 1 + 2**-11 + 2**-23; rounding to float64 first and then to float32
    # would land on the tie and round to even (1 + 2**-11)
    a = torch.tensor([1 + 2.0**-12], dtype=torch.float32)
    c = torch.tensor([2.0**-70], dtype=torch.float32)
    got = fma_f32(a, a, c)
    assert got.item() == float(np.float32(1 + 2.0**-11 + 2.0**-23))
    # and on random data it agrees with the exact rational result
    from fractions import Fraction
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    got = fma_f32(*(torch.from_numpy(v) for v in x)).numpy()
    for i in range(0, 2000, 7):
        exact = Fraction(float(x[0, i])) * Fraction(float(x[1, i])) \
            + Fraction(float(x[2, i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.int32)) & 1))
        assert got[i] == best


def test_kernel_wrappers_refuse_bad_inputs():
    with pytest.raises(TypeError):
        pairwise._points(torch.zeros(3, 2, dtype=torch.int32),
                         torch.zeros(3, 2), "pairwise_count")
    with pytest.raises(ValueError, match="d differs"):
        pairwise._points(torch.zeros(3, 2), torch.zeros(3, 3),
                         "pairwise_count")
    with pytest.raises(ValueError, match="CUDA"):
        pairwise._check_card(torch.zeros(3, 2), "pairwise_count")
