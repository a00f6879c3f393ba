"""Tile parity: the plain versions of the tile kernels (``kernels/ref.py``,
the CPU path of ``pairwise_count``/``pairwise_minlabel``) against the JAX
Pallas tile kernels in interpret mode and the JAX plain oracles.

Tolerance: zero, with two kinds of data.
  * Against the Pallas kernels, on any data: the port computes the
    kernels' own MXU-form distance with the same float32 roundings (each
    norm and the dot product are the first axis's product then one fused
    multiply-add per further axis, as the compiled reference rounds them,
    and eps is squared in float32), so counts and labels are byte-equal
    even for pairs at the eps boundary.
  * Against ``repro/kernels/ref.py``, on boundary-separated data only:
    that oracle uses the other form, sum((q - r)^2) against eps*eps in
    double, which can flip a pair within about one ulp of eps.
The CUDA kernels (``csrc/pairwise.cu``) repeat the plain arithmetic and are
held against it on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import pairwise as jpairwise  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.core.lbvh import fma_f32  # noqa: E402
from repro_torch.kernels import pairwise  # noqa: E402

from conftest import separated_points  # noqa: E402

SHAPES = [(7, 5), (130, 257), (1, 1)]
INT_MAX = 2**31 - 1


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("nq,nr", SHAPES)
def test_count_matches_pallas_and_oracle(nq, nr, d):
    pts = separated_points(nq + nr, d, eps=0.2, seed=nq + nr + d)
    q, r = pts[:nq], pts[nq:]
    out = pairwise.pairwise_count(_t(q), _t(r), 0.2)
    assert out.dtype == torch.int32 and out.shape == (nq,)
    np.testing.assert_array_equal(
        np.asarray(jpairwise.pairwise_count(q, r, 0.2)), out.numpy())
    np.testing.assert_array_equal(
        np.asarray(jref.pairwise_count_ref(q, r, 0.2)), out.numpy())


@pytest.mark.parametrize("nq,nr", SHAPES)
def test_minlabel_matches_pallas_and_oracle(nq, nr):
    rng = np.random.default_rng(nq * 7 + nr)
    pts = separated_points(nq + nr, 2, eps=0.2, seed=nq + 31 * nr)
    q, r = pts[:nq], pts[nq:]
    labels = rng.integers(0, max(nr, 1), size=nr).astype(np.int32)
    mask = rng.random(nr) > 0.4
    out_l, out_c = pairwise.pairwise_minlabel(_t(q), _t(r), _t(labels),
                                              _t(mask), 0.2)
    for jl, jc in (jpairwise.pairwise_minlabel(q, r, labels, mask, 0.2),
                   jref.pairwise_minlabel_ref(q, r, jnp.asarray(labels),
                                              jnp.asarray(mask), 0.2)):
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


@pytest.mark.parametrize("d", [2, 3])
def test_boundary_pairs_match_pallas_kernels(d):
    # points on a coarse grid put many pairs at exactly eps (and at the
    # ulps around it): only identical arithmetic agrees on all of them
    rng = np.random.default_rng(d)
    pts = (rng.integers(0, 12, (300, d)) * np.float32(0.1)
           + rng.uniform(-1e-7, 1e-7, (300, d))).astype(np.float32)
    eps = 0.3
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
