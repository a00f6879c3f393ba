"""Plain reference for a streaming handle's answers.

A probe's answer, over the active points (their insert ids ``gids``) and
their clustering: ``counts`` is the number of active points within eps,
saturated at ``min_pts``; ``label`` is -1 when no core point is within eps,
else the smallest, over the core points within eps, of their cluster's
representative (the smallest insert id among the cluster's core points);
``would_be_core`` is ``counts + 1 >= min_pts``.
"""
from __future__ import annotations

import torch

from .dbscan_ref import INF, Rounding, neighbours_of, radius2, BLOCK


def check_queries(pts: torch.Tensor, gids: torch.Tensor, core: torch.Tensor,
                  comps: list, probes: torch.Tensor, labels, counts,
                  would_be_core, eps: float, min_pts: int, rounding,
                  block: int = BLOCK) -> dict:
    """Violations in one batch of probe answers. ``comps`` are the
    strict and loose component tensors of ``dbscan_ref.components`` over
    ``pts`` with core mask ``core`` (the smallest row index of each
    component)."""
    rnd = rounding if isinstance(rounding, Rounding) else Rounding.of(rounding)
    dev = pts.device
    k = probes.shape[0]
    labels = torch.as_tensor(labels, device=dev).long()
    counts = torch.as_tensor(counts, device=dev).long()
    wbc = torch.as_tensor(would_be_core, device=dev).bool()
    strict_c, loose_c = comps[0], comps[-1]
    # a component's representative: the insert id of its smallest row
    # (rows are in insert order, so that is its smallest insert id)
    rep_s = torch.where(strict_c >= 0, gids[strict_c.clamp_min(0)], INF)
    rep_l = torch.where(loose_c >= 0, gids[loose_c.clamp_min(0)], INF)
    cs = torch.zeros(k, dtype=torch.int64, device=dev)
    cl = torch.zeros(k, dtype=torch.int64, device=dev)
    hi = torch.full((k,), INF, dtype=torch.int64, device=dev)
    lo = torch.full((k,), INF, dtype=torch.int64, device=dev)
    for qi, j, s, l in neighbours_of(probes, pts, eps, rnd, block):
        cs.index_add_(0, qi, s.long())
        cl.index_add_(0, qi, l.long())
        cj = core[j]
        ss, ll = s & cj, l & cj
        hi = hi.scatter_reduce(0, qi[ss], rep_s[j[ss]], "amin")
        lo = lo.scatter_reduce(0, qi[ll], rep_l[j[ll]], "amin")
    cs, cl = cs.clamp_max(min_pts), cl.clamp_max(min_pts)
    count_bad = (counts < cs) | (counts > cl)
    none = lo == INF
    label_bad = torch.where(
        none, labels != -1,
        torch.where(hi < INF, (labels < lo) | (labels > hi),
                    (labels != -1) & (labels < lo)))
    return {"query_count_errors": int(count_bad.sum()),
            "query_label_errors": int(label_bad.sum()),
            "query_core_errors": int((wbc != (counts + 1 >= min_pts)).sum())}


def brute_counts(probes: torch.Tensor, pts: torch.Tensor, eps: float,
                 min_pts: int, rounding, rows: int = 16):
    """(surely, maybe) counts of ``pts`` within eps of each probe,
    saturated at ``min_pts``, by testing every pair (``rows`` probes at a
    time)."""
    rnd = rounding if isinstance(rounding, Rounding) else Rounding.of(rounding)
    eps2 = radius2(eps)
    cs, cl = [], []
    for lo in range(0, probes.shape[0], rows):
        diff = probes[lo:lo + rows, None, :] - pts[None, :, :]
        s, l = rnd.within(diff, eps2)
        cs.append(s.sum(1))
        cl.append(l.sum(1))
    return (torch.cat(cs).clamp_max(min_pts),
            torch.cat(cl).clamp_max(min_pts))


def answer_queries(pts: torch.Tensor, gids: torch.Tensor, core: torch.Tensor,
                   comp: torch.Tensor, probes: torch.Tensor, eps: float,
                   min_pts: int, rounding, block: int = BLOCK):
    """The reference's own answers ``(labels, counts, would_be_core)`` to
    a probe batch, over ``pts`` with core mask ``core`` and components
    ``comp`` (``dbscan_ref.components``). The control puts these, in a
    lower precision, in the program's place."""
    rnd = rounding if isinstance(rounding, Rounding) else Rounding.of(rounding)
    dev = pts.device
    k = probes.shape[0]
    rep = torch.where(comp >= 0, gids[comp.clamp_min(0)], INF)
    counts = torch.zeros(k, dtype=torch.int64, device=dev)
    best = torch.full((k,), INF, dtype=torch.int64, device=dev)
    for qi, j, s, _ in neighbours_of(probes, pts, eps, rnd, block):
        counts.index_add_(0, qi, s.long())
        sc = s & core[j]
        best = best.scatter_reduce(0, qi[sc], rep[j[sc]], "amin")
    counts = counts.clamp_max(min_pts)
    labels = torch.where(best == INF, -1, best)
    return labels, counts, counts + 1 >= min_pts
