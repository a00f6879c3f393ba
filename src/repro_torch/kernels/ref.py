"""Plain PyTorch versions of the two tile kernels (``csrc/pairwise.cu``).

They compute what the kernels compute, with the same float32 arithmetic,
over the whole (nq, nr) distance matrix in row blocks: the CPU path of
``pairwise_count``/``pairwise_minlabel``, and the reference the kernels are
held against on the card.

The squared distance is the MXU form of the Pallas tile kernels
(``_tile_dist2``, src/repro/kernels/pairwise.py):
``(|q|^2 + |r|^2) - 2 <q, r>``. The dot product is rounded as the
reference's compiled float32 code rounds it at every d: the first axis's
product, then one fused multiply-add per further axis, in axis order. The
norms follow :func:`tile_sum_sq`. ``eps`` is rounded to float32 and squared
in float32, as the jitted reference squares its traced ``eps``.
"""
from __future__ import annotations

import torch

from repro_torch.core.lbvh import fma_f32, sum_sq
from repro_torch.core.traversal import radius2

INT_MAX = 2**31 - 1
_ROWS = 1024        # query rows per block of the distance matrix
WINDOW = 32         # axes a partial sum of a long norm covers


def norm_windows(d: int) -> list[tuple[int, int]]:
    """The axis ranges [lo, hi) whose sums make up a tile norm over d axes:
    one range for d <= 32; above, windows of 32 over d padded up to a
    multiple of 32, with half the padding (rounded down) in front of axis
    0 and the rest after axis d - 1."""
    if d <= WINDOW:
        return [(0, d)]
    low = (-d % WINDOW) // 2
    return [(max(s, 0), min(s + WINDOW, d)) for s in range(-low, d, WINDOW)]


def _sum_unfused(x):
    """``x0*x0 + x1*x1 + ...`` in axis order, every product and sum rounded
    on its own."""
    sq = x * x
    out = sq[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + sq[..., k]
    return out


def tile_sum_sq(x, fma: bool = True):
    """Sum of squares over the last axis, rounded as the reference's tile
    kernels round ``jnp.sum(q * q, -1)`` (XLA's CPU compiler, jax 0.9,
    x86-64 with AVX-512; measured by ``tools/tile_rounding.py`` inside a
    Pallas kernel in interpret mode at every d from 1 to 70 and at 80, 96,
    127 to 129, 200, 256 and 300):

    * d <= 4 and 9 <= d <= 32: ``x0*x0``, then one fused multiply-add per
      further axis (:func:`repro_torch.core.lbvh.sum_sq`);
    * 5 <= d <= 8: squares and sums each rounded on their own, in axis
      order (the compiler vectorizes the squares at these widths, so
      nothing is fused);
    * d >= 33: the compiler splits the reduction into windows of 32
      (:func:`norm_windows`); each window is summed as above, unfused, and
      the window sums are added in order.

    ``fma=False`` is the same window rule with nothing fused at any d: how
    the reference's *eager* ``jnp.sum((q - p) ** 2, -1)`` rounds
    (``neighbors.neighbor_count``'s brute path; measured on the host, jax
    0.9.0, at d = 1, 4, 5, 8, 17, 32, 33, 48, 64, 65 and 100).
    """
    d = x.shape[-1]
    if fma and (d <= 4 or 9 <= d <= WINDOW):
        return sum_sq(x)
    parts = [_sum_unfused(x[..., lo:hi]) for lo, hi in norm_windows(d)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def tile_dist2(q, r):
    """(nq, nr) float32 squared distances in the MXU form."""
    qn = tile_sum_sq(q)
    rn = tile_sum_sq(r)
    cross = q[:, None, 0] * r[None, :, 0]
    for k in range(1, q.shape[1]):
        cross = fma_f32(q[:, None, k], r[None, :, k], cross)
    return (qn[:, None] + rn[None, :]) - 2.0 * cross


def pairwise_count_ref(points_q, points_r, eps, cap: int = INT_MAX):
    """Counts of reference points within eps per query (saturating at
    cap), int32."""
    q, r = points_q.to(torch.float32), points_r.to(torch.float32)
    e2 = radius2(eps)
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for lo in range(0, q.shape[0], _ROWS):
        d2 = tile_dist2(q[lo:lo + _ROWS], r)
        out[lo:lo + _ROWS] = (d2 <= e2).sum(1).to(torch.int32)
    return torch.clamp_max(out, cap)


def pairwise_minlabel_ref(points_q, points_r, labels_r, mask_r, eps):
    """(min masked label within eps, matched count) per query, int32."""
    q, r = points_q.to(torch.float32), points_r.to(torch.float32)
    e2 = radius2(eps)
    lab = labels_r.to(torch.int32)
    keep = mask_r != 0
    out_l = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    out_c = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for lo in range(0, q.shape[0], _ROWS):
        ok = (tile_dist2(q[lo:lo + _ROWS], r) <= e2) & keep[None, :]
        labs = torch.where(ok, lab[None, :], INT_MAX)
        if labs.shape[1] == 0:
            out_l[lo:lo + _ROWS] = INT_MAX
        else:
            out_l[lo:lo + _ROWS] = labs.amin(1)
        out_c[lo:lo + _ROWS] = ok.sum(1).to(torch.int32)
    return out_l, out_c
