"""The tiled DBSCAN backend over the two tile kernels.

``dbscan_tiled`` runs the whole two-phase framework of the paper with
neighbor determination done by streaming distance tiles instead of a tree
walk: a saturating count pass finds the core points, hook sweeps with
pointer jumping run to a fixpoint, and one last gather assigns the border
points. It is the backend of choice when the point count is small enough
that all n^2 pairs cost less than a divergent walk. Memory stays O(n): the
distance tiles live in shared memory only.
"""
from __future__ import annotations

import torch

from repro_torch.core import unionfind
from .pairwise import INT_MAX, pairwise_count, pairwise_minlabel


def _tiled_phases(pts, eps, min_pts: int):
    n = pts.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=pts.device)

    # -- preprocessing: early-exit (saturating) neighbor count ------------
    counts = pairwise_count(pts, pts, eps, cap=min_pts)
    core = counts >= min_pts

    # -- main phase: fused hook tiles + pointer jumping to fixpoint -------
    labels = torch.where(core, idx, INT_MAX)
    while True:
        gathered, _ = pairwise_minlabel(pts, pts,
                                        torch.where(core, labels, INT_MAX),
                                        core, eps)
        new = torch.where(core, torch.minimum(labels, gathered), labels)
        compressed = unionfind.jump_to_fixpoint(torch.where(core, new, idx))
        new = torch.where(core, compressed, labels)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break

    # -- borders ----------------------------------------------------------
    blab, _ = pairwise_minlabel(pts, pts, torch.where(core, labels, INT_MAX),
                                core, eps)
    labels = torch.where(core, labels, blab)
    return torch.where(labels == INT_MAX, -1, labels), core


def dbscan_tiled(points: torch.Tensor, eps: float, min_pts: int, *,
                 star: bool = False):
    """Full DBSCAN on distance tiles (labels compacted, noise = -1).

    ``points`` is an (n, d) tensor; the kernels run on its device (the
    plain versions on the CPU). star=True implements DBSCAN* (non-core
    points become noise).
    """
    from repro_torch.core.fdbscan import DBSCANResult, _finalize
    pts = points.to(torch.float32)
    n = pts.shape[0]
    labels_rep, core = _tiled_phases(pts, eps, min_pts)
    if star:
        labels_rep = torch.where(core, labels_rep, -1)
    labels, n_clusters = _finalize(
        labels_rep, torch.arange(n, dtype=torch.int32, device=pts.device), n)
    return DBSCANResult(labels=labels, core_mask=core,
                        n_clusters=n_clusters, n_sweeps=-1,
                        n_traversals=0, backend="tiled")
