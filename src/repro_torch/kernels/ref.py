"""Plain PyTorch versions of the two tile kernels (``csrc/pairwise.cu``).

They compute what the kernels compute, with the same float32 arithmetic,
over the whole (nq, nr) distance matrix in row blocks: the CPU path of
``pairwise_count``/``pairwise_minlabel``, and the reference the kernels are
held against on the card.

The squared distance is the MXU form of the Pallas tile kernels
(``_tile_dist2``, src/repro/kernels/pairwise.py):
``(|q|^2 + |r|^2) - 2 <q, r>``, where each norm and the dot product are
rounded as the reference's compiled float32 code rounds them: the first
axis's product, then one fused multiply-add per further axis, in axis
order. ``eps`` is rounded to float32 and squared in float32, as the jitted
reference squares its traced ``eps``.
"""
from __future__ import annotations

import torch

from repro_torch.core.lbvh import fma_f32, sum_sq
from repro_torch.core.traversal import radius2

INT_MAX = 2**31 - 1
_ROWS = 1024        # query rows per block of the distance matrix


def tile_dist2(q, r):
    """(nq, nr) float32 squared distances in the MXU form."""
    qn = sum_sq(q)
    rn = sum_sq(r)
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
