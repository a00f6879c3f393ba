"""Baselines the paper compares against, plus the ground-truth oracle
(the reference's ``repro.core.baselines``).

* ``dbscan_bruteforce_np`` — textbook Ester et al. BFS DBSCAN in NumPy.
  Slow and obviously correct: the oracle for every property test.
* ``gdbscan`` — G-DBSCAN [Andrade et al. 2013] as plain PyTorch on the
  run's device: it *materializes the full adjacency* (the O(E) memory
  behaviour the paper criticizes) as a dense n x n matrix and runs a
  level-synchronous BFS over it, so it is for small n. A plain function,
  not a kernel.
* ``dbscan_tiled`` lives in ``repro_torch.kernels.ops`` — the tile backend.
"""
from __future__ import annotations

import numpy as np
import torch

from .fdbscan import DBSCANResult
from .validate import neighbor_counts


def dbscan_bruteforce_np(points, eps: float, min_pts: int):
    """Oracle DBSCAN (labels, core_mask); labels compacted, noise = -1.

    Core determination shares the blocked tiles of ``validate`` (O(n*block)
    memory, float64-exact); the BFS recomputes one adjacency row per pop —
    the oracle stays obviously correct yet never holds the n x n matrix.
    """
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    e2 = eps * eps
    core = neighbor_counts(pts, eps) >= min_pts
    sq = (pts * pts).sum(-1)

    def row_adj(x):
        # same Gram form as validate.adjacency_blocks: one oracle, one
        # notion of adjacency
        return sq + sq[x] - 2.0 * (pts @ pts[x]) <= e2

    labels = np.full(n, -1, np.int64)
    cid = 0
    for s in range(n):
        if not core[s] or labels[s] != -1:
            continue
        stack = [s]
        labels[s] = cid
        while stack:
            x = stack.pop()
            if not core[x]:
                continue  # border: absorbed but does not expand
            for y in np.nonzero(row_adj(x))[0]:
                if labels[y] == -1:
                    labels[y] = cid
                    if core[y]:
                        stack.append(y)
        cid += 1
    return labels, core


def _gdbscan_labels(pts: torch.Tensor, eps: float, min_pts: int):
    """(labels, core): core labels are the smallest index of their
    core-core component, borders the smallest adjacent core label, noise
    -1. Squared distances are float32 sums of float32 squares; the radius
    is squared in float32."""
    n = pts.shape[0]
    r2 = torch.tensor(eps, dtype=torch.float32, device=pts.device) ** 2
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    adj = d2 <= r2                               # the materialized graph
    core = adj.sum(1) >= min_pts
    cc_adj = adj & core[:, None] & core[None, :]
    idx = torch.arange(n, dtype=torch.int64, device=pts.device)
    # Level-synchronous BFS from all sources at once == iterative min-label
    # frontier expansion over the core-core graph.
    labels = torch.where(core, idx, n)
    while True:
        relaxed = torch.where(cc_adj, labels[None, :], n).amin(1)
        new = torch.where(core, torch.minimum(labels, relaxed), labels)
        if bool((new == labels).all()):
            break
        labels = new
    # borders: min core-neighbor label
    bl = torch.where(adj & core[None, :], labels[None, :], n).amin(1)
    labels = torch.where(core, labels, torch.where(bl < n, bl, -1))
    return labels, core


def gdbscan(points, eps: float, min_pts: int, *, device=None) -> DBSCANResult:
    """G-DBSCAN on ``device`` (default the current CUDA device; ``"cpu"``
    runs on the host). Labels are compacted in order of first appearance;
    ``n_sweeps`` is 0 (the reference's record)."""
    from .dispatch import as_points, resolve_device
    from .validate import check_points
    check_points(points)
    pts = as_points(points, resolve_device(device))
    labels, core = _gdbscan_labels(pts, eps, int(min_pts))
    lab = labels.cpu().numpy()
    uniq: dict = {}
    out = np.full(lab.shape, -1, np.int32)
    for i, l in enumerate(lab):
        if l >= 0:
            out[i] = uniq.setdefault(int(l), len(uniq))
    return DBSCANResult(labels=torch.from_numpy(out).to(pts.device),
                        core_mask=core, n_clusters=len(uniq), n_sweeps=0)
