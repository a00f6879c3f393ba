"""Unified backend dispatch for DBSCAN.

One entry point — ``dbscan(points, eps, min_pts, algorithm="auto")`` —
serving the backends:

  * ``fdbscan``          — singleton-segment BVH (Morton order); the index
                           is eps-independent, so it is cached per point set
                           and reused verbatim across ``eps``/``min_pts``.
  * ``fdbscan-densebox`` — mixed dense-cell/loose-point BVH; the eps-grid
                           build doubles as the density probe that drives
                           the auto heuristic, so choosing this backend
                           costs no extra work.
  * ``tiled``            — the tile kernels (kernels/ops.py): all n^2
                           distance pairs beat a divergent tree walk when
                           the point count is small.
  * ``pallas-tree``      — the hand-written walk kernel over the plain
                           fdbscan index (the name is the reference's, kept
                           for API parity). On the card an auto tree
                           decision becomes this backend; the index stays
                           the one the decision chose.

Every walk runs where the points are: on a CUDA device each walk of every
tree backend is the walk kernel, so the tree backends differ on the card
only in their index; on the CPU each walk is the plain engine.

``plan()`` performs the (cacheable) decision + index build; ``dbscan()``
executes a plan. Plans are memoized in a small LRU keyed by point-set
content hash, device and parameters, with the eps-independent fdbscan
index shared across all eps/min_pts entries of the same point set.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

from . import fdbscan, grid, lbvh
from .validate import check_points

# Below this size the n^2 tile sweep is cheaper than divergent traversal.
TILED_MAX_POINTS = 1024
# Minimum fraction of points inside dense cells for the DenseBox index to
# pay for its grid pass (paper Fig. 6: sparse/high-minpts regimes have ~0).
DENSE_FRACTION_MIN = 0.05

_CACHE_MAX = 32
_plan_cache: "OrderedDict[Any, Any]" = OrderedDict()

ALGORITHMS = ("auto", "fdbscan", "fdbscan-densebox", "tiled", "sharded",
              "stream", "pallas-tree")
# Backends of the reference that this package does not have yet, with the
# ROADMAP item that brings each.
_NOT_YET = {
    "sharded": "ROADMAP Queue 1, distributed (multi-device tree path)",
    "stream": "ROADMAP Queue 1, stream and durability (streaming index)",
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device. Without a CUDA device and without ``device``
    this raises instead of quietly running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the host")
    return torch.device("cuda", torch.cuda.current_device())


def as_points(points, device: torch.device) -> torch.Tensor:
    """(n, d) float32 contiguous tensor on ``device`` (validated first by
    :func:`check_points`). The port computes in float32, the reference's
    precision for float32 and float64 input (it runs without 64-bit
    mode)."""
    if isinstance(points, torch.Tensor):
        t = points.detach()
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(points)))
    return t.to(device=device, dtype=torch.float32).contiguous()


def _accel(device: torch.device) -> bool:
    """Do the points live on a CUDA device (the walk kernel's home)?"""
    return device.type == "cuda"


def _maybe_kernel(p: "Plan", algorithm: str) -> "Plan":
    """Name an auto tree decision on the card as the walk-kernel backend.
    Every walk on a CUDA index is the kernel already; the plan keeps the
    index the decision chose and records why."""
    if algorithm != "auto" or p.tree is None or not _accel(p.device):
        return p
    stats = dict(p.stats)
    stats["reason"] = (stats.get("reason", "") +
                       "; CUDA device: hand-written walk kernel")
    return p._replace(backend="pallas-tree", stats=stats)


class Plan(NamedTuple):
    """A resolved backend choice plus the (reusable) index that drove it.

    backend: one of "fdbscan", "fdbscan-densebox", "pallas-tree", "tiled".
    segs / tree: the segment index and its LBVH (None for the index-free
        tiled backend, and tree is None below two segments).
    stats: occupancy/size stats behind the choice; ``stats["reason"]``
        states why this backend won.
    device: where the index lives and the clustering runs.
    walk_index: the index's packed layout for the walk kernel
        (``repro_torch.kernels.walkpack.WalkIndex``), built with the index
        on a CUDA device; None on the CPU and without a tree.
    """
    backend: str
    segs: grid.Segments | None
    tree: lbvh.Tree | None
    stats: dict
    device: torch.device
    walk_index: Any = None


def clear_cache() -> None:
    _plan_cache.clear()


def cache_info() -> dict:
    return {"entries": len(_plan_cache), "max": _CACHE_MAX}


def _points_key(points: torch.Tensor) -> str:
    arr = np.ascontiguousarray(points.detach().cpu().numpy())
    h = hashlib.sha1(arr.tobytes())
    h.update(repr((arr.shape, str(arr.dtype), str(points.device))).encode())
    return h.hexdigest()


def _cache_get(key):
    if key in _plan_cache:
        _plan_cache.move_to_end(key)
        return _plan_cache[key]
    return None


def _cache_put(key, val):
    _plan_cache[key] = val
    _plan_cache.move_to_end(key)
    while len(_plan_cache) > _CACHE_MAX:
        _plan_cache.popitem(last=False)
    return val


def _tree_of(segs: grid.Segments):
    if segs.n_segments < 2 or segs.n_points < 2:
        return None
    return lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)


def _walk_index_of(segs: grid.Segments, tree):
    """The walk kernel's packed layout of the index, for a tree on a CUDA
    device (the only place the kernel reads it) in d = 2 or 3 (the only
    dimensions it takes; a walk raises for others); else None."""
    if (tree is None or not _accel(segs.pts.device)
            or segs.pts.shape[1] not in (2, 3)):
        return None
    from repro_torch.kernels.walkpack import pack_index
    return pack_index(tree, segs)


def _fdbscan_plan(points, pkey: str, stats: dict) -> Plan:
    """Plain-FDBSCAN plan; the index is eps-independent and shared across
    every (eps, min_pts) plan for the same point set."""
    base_key = (pkey, "fdbscan-index")
    cached = _cache_get(base_key)
    if cached is None:
        segs = grid.build_segments_fdbscan(points)
        tree = _tree_of(segs)
        cached = _cache_put(base_key,
                            (segs, tree, _walk_index_of(segs, tree)))
    segs, tree, walk_index = cached
    return Plan("fdbscan", segs, tree, stats, points.device, walk_index)


def plan(points, eps: float, min_pts: int, algorithm: str = "auto",
         mesh=None, *, device=None) -> Plan:
    """Choose a backend and build (or fetch) its index.

    The densebox grid build is reused as the density probe: its dense-point
    fraction decides densebox-vs-plain, and on a densebox decision the very
    same segments become the index. On a CUDA device an auto tree decision
    becomes the ``pallas-tree`` (walk kernel) backend.

    Args:
        points: (n, d) points (array-like or tensor; computed in float32).
        eps: DBSCAN radius (non-negative).
        min_pts: DBSCAN density threshold (the query point counts).
        algorithm: one of :data:`ALGORITHMS`; ``"auto"`` probes and picks.
        mesh: multi-device routing — not in this package yet.
        device: where to build and run; default the current CUDA device
            (``RuntimeError`` if there is none).

    Raises:
        ValueError: unknown ``algorithm``; negative ``eps``; malformed
            ``points`` (see :func:`check_points`).
        NotImplementedError: ``sharded``, ``stream`` or ``mesh=``, which
            later ROADMAP items bring.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if mesh is not None:
        raise NotImplementedError(
            f"mesh= is not supported yet: {_NOT_YET['sharded']}")
    if algorithm in _NOT_YET:
        raise NotImplementedError(
            f"algorithm={algorithm!r} is not supported yet: "
            f"{_NOT_YET[algorithm]}")
    if eps < 0:
        raise ValueError(f"eps must be non-negative; got {eps}"
                         " (a negative eps would be squared away silently)")
    check_points(points)
    points = as_points(points, resolve_device(device))
    n, d = points.shape
    pkey = _points_key(points)
    key = (pkey, float(eps), int(min_pts), algorithm)
    hit = _cache_get(key)
    if hit is not None:
        return hit

    stats: dict = {"n": n, "d": d}
    if algorithm == "tiled" or (algorithm == "auto" and n <= TILED_MAX_POINTS):
        stats["reason"] = ("explicit" if algorithm == "tiled"
                           else f"n <= {TILED_MAX_POINTS}: tiles win")
        return _cache_put(key, Plan("tiled", None, None, stats,
                                    points.device))

    if algorithm == "pallas-tree":
        # the walk kernel over the plain (eps-independent, cached) fdbscan
        # index — the explicit form of the auto decision on the card
        stats["reason"] = "explicit: hand-written walk kernel"
        return _cache_put(key, _fdbscan_plan(points, pkey, stats)._replace(
            backend="pallas-tree"))

    if algorithm == "fdbscan" or d not in (2, 3):
        stats["reason"] = ("explicit" if algorithm == "fdbscan"
                           else "no eps-grid for this dimensionality")
        return _cache_put(key, _maybe_kernel(
            _fdbscan_plan(points, pkey, stats), algorithm))

    # eps-grid build: density probe and (potentially) the index itself
    segs = grid.build_segments_densebox(points, eps, min_pts)
    dense_frac = float(segs.dense_pt.float().mean())
    stats.update(dense_fraction=dense_frac, n_segments=segs.n_segments)
    if algorithm == "fdbscan-densebox" or dense_frac >= DENSE_FRACTION_MIN:
        stats["reason"] = ("explicit" if algorithm == "fdbscan-densebox"
                           else f"dense_fraction >= {DENSE_FRACTION_MIN}")
        tree = _tree_of(segs)
        return _cache_put(key, _maybe_kernel(
            Plan("fdbscan-densebox", segs, tree, stats, points.device,
                 _walk_index_of(segs, tree)), algorithm))
    stats["reason"] = f"dense_fraction < {DENSE_FRACTION_MIN}: plain tree"
    return _cache_put(key, _maybe_kernel(
        _fdbscan_plan(points, pkey, stats), algorithm))


def dbscan(points, eps: float, min_pts: int, *, algorithm: str = "auto",
           star: bool = False, frontier: bool = True, mesh=None,
           query_plan: Plan | None = None,
           device=None) -> fdbscan.DBSCANResult:
    """DBSCAN with automatic backend selection (the unified entry point).

    ``query_plan`` short-circuits planning entirely — pass the result of a
    previous :func:`plan` call *for the same point set* to amortize the
    index build across runs (the plan's index, not ``points``, is what a
    tree backend clusters; the run happens on the plan's device).

    Args:
        points: (n, d) points (array-like or tensor).
        eps: DBSCAN radius (non-negative).
        min_pts: DBSCAN density threshold (the query point counts, so a
            point with ``min_pts - 1`` neighbors is core).
        algorithm: backend request, see :func:`plan`.
        star: DBSCAN* variant — no border points, non-core points are
            noise.
        frontier: restrict label sweeps to the changed-point frontier
            (exact, default True); only for the tree backends.
        mesh: see :func:`plan`.
        query_plan: a previous :func:`plan` result for the same points.
        device: see :func:`plan`.

    Returns:
        A :class:`repro_torch.core.fdbscan.DBSCANResult` whose tensors live
        on the run's device; ``labels[i] == -1`` marks noise, ``backend``
        names the backend that actually ran.

    Raises:
        RuntimeError: no CUDA device and no ``device`` given.
        ValueError: invalid parameters (see :func:`plan`), or ``frontier``
            combined with the tiled backend, which would ignore it.
        NotImplementedError: see :func:`plan`.
    """
    check_points(points)
    if query_plan is not None:
        p = query_plan
    else:
        p = plan(points, eps, min_pts, algorithm, mesh, device=device)
    if p.backend == "tiled":
        if frontier is not True:
            raise ValueError(
                f"frontier={frontier!r} is incompatible with the tiled "
                "backend: frontier restriction only applies to the "
                "tree-sweep backends and would silently be ignored (drop "
                "the kwarg, or pick algorithm='fdbscan'/'fdbscan-densebox')")
        from repro_torch.kernels import ops
        return ops.dbscan_tiled(as_points(points, p.device), eps, min_pts,
                                star=star)
    return fdbscan.cluster_from_index(p.segs, p.tree, eps, min_pts,
                                      star=star, frontier=frontier,
                                      backend=p.backend,
                                      walk_index=p.walk_index)
