"""Neighbor-query workloads over the predicate/callback engine.

The DBSCAN epilogues are instances of a generic query engine; this module
exposes the other workloads it opens — the fixed-radius searches of
Wang/Gu/Shun's parallel-DBSCAN framing and the k-nearest-neighbor graphs of
KNN-DBSCAN (Chen et al.) — behind three entry points:

  * :func:`neighbor_count`   — |N_r(q)| per query (early-exit capable);
  * :func:`radius_visit`     — run *your own* visitor over every in-radius
                               neighbor (the raw extensibility hook);
  * :func:`knn`              — exact k nearest neighbors, optionally
                               radius-capped (``nearest(k)`` predicates).

All three route through :mod:`repro_torch.core.dispatch`'s plan cache, so
the (eps-independent) plain-FDBSCAN index and its packed layout are shared
with ``dbscan`` runs and across repeated neighbor queries on the same point
set. Queries may be the resident points themselves or an external batch
(``query_pts=``).

Where each runs: on a CUDA device ``neighbor_count`` is the walk kernel's
count kind (``csrc/walk.cu``) and ``knn`` the k-NN walk kernel
(``csrc/knn.cu``); on the CPU both run the plain engine. ``radius_visit``
drives a Python visitor, so it runs the plain engine wherever the index is.

Inputs outside the tree's reach — d not in (2, 3) (no Morton curve) or
fewer than two points — fall back to an exact brute-force path with the
same tie rules, so the API is total. Each entry point takes ``device=`` as
``dbscan`` does: the current CUDA device unless the caller asks for another.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import dispatch, traversal
from .validate import check_points

INT_MAX = traversal.INT_MAX
# Elements of one block of the brute-force distance tensor (q x n x d).
_BRUTE_BLOCK = 1 << 24


def _check_inputs(points, query_pts):
    """Shared input gate: resident points must be a non-empty finite
    batch; external queries (when given) must match their d. An *empty*
    external batch is fine — it just returns empty results. Returns the
    resident batch's (n, d)."""
    pts = check_points(points)
    if query_pts is not None:
        check_points(query_pts, name="query_pts", allow_empty=True,
                     d=pts.shape[1])
    return pts.shape


class KNNResult(NamedTuple):
    """k nearest neighbors per query, ascending by (distance, index).

    indices:   (q, k) int32 neighbor ids in *original* point order; -1
               pads slots beyond the reachable neighbor count (k > n, or a
               radius cap excluded the rest).
    distances: (q, k) float32 euclidean distances (+inf on padded slots).

    A resident query (``query_pts=None``) is its own nearest neighbor at
    distance 0 — slice it off if self-matches are unwanted.
    """
    indices: torch.Tensor
    distances: torch.Tensor


def _tree_plan(points, device):
    """The cached eps-independent plain-FDBSCAN index for ``points``."""
    return dispatch.plan(points, 0.0, 1, algorithm="fdbscan", device=device)


def _query_tensor(p, query_pts):
    """External query coordinates on the index's device, or None."""
    if query_pts is None:
        return None
    return dispatch.as_points(query_pts, p.device)


def _scatter_resident(segs, per_lane):
    """Map a sorted-order per-lane tensor back to original point order."""
    out = torch.zeros((segs.n_points,) + tuple(per_lane.shape[1:]),
                      dtype=per_lane.dtype, device=per_lane.device)
    out[segs.order.long()] = per_lane
    return out


def radius_visit(points, r: float, callback, carry=None, *,
                 query_pts=None, device=None) -> traversal.Trace:
    """Run ``callback`` over every neighbor within ``r`` of each query.

    The raw engine hook: ``callback`` is any
    :class:`repro_torch.core.traversal.Visitor` and the returned
    :class:`~repro_torch.core.traversal.Trace` holds its final carry (in
    the index's *sorted* lane order for resident queries — the visitor sees
    sorted point ids ``j``; ``segs.order[j]`` maps them back). Builds (or
    fetches) the cached tree index for ``points``.

    A visitor written in Python cannot become a kernel, so this runs the
    plain engine (:func:`repro_torch.core.traversal.traverse`, counted in
    ``traverse.runs``) on the index's device, the card included — as the
    reference runs it on its own plain engine, never on a kernel.

    Args:
        points: (n, d) resident points, d in (2, 3), n >= 2.
        r: search radius per query.
        callback: a visitor instance.
        carry: optional initial accumulator (a tensor or a (named) tuple of
            tensors, leading dim = lane count); ``None`` asks the
            callback's ``init_carry``.
        query_pts: optional (q, d) external query batch; ``None``
            traverses for every resident point.
        device: where to build and run; default the current CUDA device
            (``RuntimeError`` if there is none).

    Returns:
        The :class:`~repro_torch.core.traversal.Trace` — final carry plus
        the engine's per-lane ``evals``/``iters`` work counters.

    Raises:
        ValueError: malformed inputs (empty/NaN/Inf, see
            :func:`repro_torch.core.validate.check_points`), or no tree
            index exists for these points (< 2 points or d outside (2, 3))
            — use :func:`neighbor_count`/:func:`knn`, whose brute-force
            fallbacks cover degenerate inputs.
    """
    _check_inputs(points, query_pts)
    p = _tree_plan(points, dispatch.resolve_device(device))
    if p.tree is None:
        raise ValueError("radius_visit needs a tree index (>= 2 points "
                         "with d in (2, 3)); use neighbor_count/knn, whose "
                         "brute-force fallbacks cover degenerate inputs")
    return traversal.traverse(
        p.tree, p.segs,
        traversal.intersects(traversal.sphere(r),
                             pts=_query_tensor(p, query_pts)),
        callback, carry=carry)


def _count_brute(pts, q, r: float, cap: int):
    """Exact counts by brute force on ``pts``' device, rounded as the
    reference's eager ``jnp.sum((q - p) ** 2, -1)`` (no fused
    multiply-add; ``kernels/ref.py: tile_sum_sq(fma=False)``)."""
    from repro_torch.kernels.ref import tile_sum_sq
    n, d = pts.shape
    r2 = traversal.radius2(r)
    out = torch.empty(q.shape[0], dtype=torch.int32, device=pts.device)
    rows = max(1, _BRUTE_BLOCK // max(1, n * d))
    for lo in range(0, q.shape[0], rows):
        d2 = tile_sum_sq(q[lo:lo + rows, None, :] - pts[None, :, :],
                         fma=False)
        out[lo:lo + rows] = (d2 <= r2).sum(1).to(torch.int32)
    return torch.clamp_max(out, cap)


def neighbor_count(points, r: float, *, query_pts=None, cap: int = INT_MAX,
                   device=None) -> torch.Tensor:
    """|N_r(q)| per query point, saturated at ``cap`` (early exit).

    Resident queries count themselves (|N_r| includes the center, as in
    DBSCAN's core test); external queries count every resident match. On a
    CUDA device the counts come from the walk kernel (count kind).

    Args:
        points: (n, d) resident points (any n, any d — inputs outside
            the tree's reach fall back to exact brute force).
        r: search radius.
        query_pts: optional (q, d) external queries; ``None`` counts for
            every resident point.
        cap: saturation bound — a lane stops traversing once its count
            reaches ``cap`` (the paper's min_pts early exit).
        device: see :func:`radius_visit`.

    Returns:
        int32 counts on the run's device, in original point order
        (resident queries) or ``query_pts`` order (external queries).

    Raises:
        ValueError: malformed inputs (empty resident set, NaN/Inf
            coordinates, query/resident dimensionality mismatch).
    """
    n, d = _check_inputs(points, query_pts)
    dev = dispatch.resolve_device(device)
    if n < 2 or d not in (2, 3):
        pts = dispatch.as_points(points, dev)
        q = pts if query_pts is None else dispatch.as_points(query_pts, dev)
        return _count_brute(pts, q, r, cap)
    from repro_torch.kernels import traverse as kt
    p = _tree_plan(points, dev)     # one plan fetch serves walk + scatter
    tr = kt.traverse(
        p.tree, p.segs,
        traversal.intersects(traversal.sphere(r),
                             pts=_query_tensor(p, query_pts)),
        traversal.CountVisitor(cap=cap), walk_index=p.walk_index)
    if query_pts is not None:
        return tr.acc
    return _scatter_resident(p.segs, tr.acc)


def knn(points, k: int, *, query_pts=None, radius=None,
        device=None) -> KNNResult:
    """Exact k nearest neighbors via the ``nearest(k)`` predicate.

    Distance-bounded rope walk: each lane prunes subtrees farther than its
    current k-th best (shrinking ball), optionally capped at ``radius``.
    Ties at the k-th distance resolve to the smaller original index —
    identical to a stable sort of the brute-force distance row. On a CUDA
    device the walk is the k-NN walk kernel (``csrc/knn.cu``).

    Args:
        points: (n, d) resident points (degenerate inputs fall back to
            an exact brute-force path with the same tie rules).
        k: neighbors per query (it sizes the result).
        query_pts: optional (q, d) external queries; ``None`` queries
            every resident point (each is its own nearest neighbor at
            distance 0).
        radius: optional search-radius cap; slots beyond the reachable
            neighbor count pad with index -1 / distance +inf.
        device: see :func:`radius_visit`.

    Returns:
        A :class:`KNNResult` with (q, k) ``indices`` (original point
        order) and ``distances`` on the run's device, ascending by
        (distance, index).

    Raises:
        ValueError: ``k < 1``, or malformed inputs (empty resident set,
            NaN/Inf coordinates, dimensionality mismatch).
    """
    if k < 1:
        raise ValueError(f"k must be >= 1; got {k}")
    n, d = _check_inputs(points, query_pts)
    dev = dispatch.resolve_device(device)
    if n < 2 or d not in (2, 3):
        return _knn_brute(points, points if query_pts is None else query_pts,
                          k, radius, dev)
    from repro_torch.kernels import knn as kknn
    p = _tree_plan(points, dev)
    tr = kknn.traverse(p.tree, p.segs,
                       traversal.nearest(k, r=radius,
                                         pts=_query_tensor(p, query_pts)),
                       walk_index=p.walk_index)
    idx, dist = tr.carry.ids, tr.carry.d2
    if query_pts is None:
        idx = _scatter_resident(p.segs, idx)
        dist = _scatter_resident(p.segs, dist)
    return KNNResult(indices=idx, distances=_sqrt_f32(dist))


def _sqrt_f32(x):
    """The correctly rounded float32 square root (as the reference's
    ``jnp.sqrt``): taken in float64 and rounded once, since PyTorch's
    vectorized float32 CPU square root misses by an ulp on some inputs."""
    return torch.sqrt(x.double()).float()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _knn_brute(points, q, k: int, radius, device) -> KNNResult:
    """Exact fallback with the same (d2, id) tie rule (host NumPy)."""
    pts = _host(points).astype(np.float32)
    qs = _host(q).astype(np.float32)
    n = len(pts)
    kk = min(k, n) if n else 0
    diff = qs[:, None, :] - pts[None, :, :]
    d2 = (diff * diff).sum(-1)
    if radius is not None:
        d2 = np.where(d2 <= np.float32(radius) ** 2, d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :kk]
    dd = np.take_along_axis(d2, idx, axis=1)
    out_i = np.full((len(qs), k), -1, np.int32)
    out_d = np.full((len(qs), k), np.inf, np.float32)
    out_i[:, :kk] = np.where(np.isinf(dd), -1, idx)
    out_d[:, :kk] = dd
    return KNNResult(indices=torch.from_numpy(out_i).to(device),
                     distances=torch.from_numpy(np.sqrt(out_d)).to(device))
