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
                           for API parity), each phase under the plan's
                           tuner state (``core.tune``). On the card an auto
                           tree decision becomes this backend; the index
                           stays the one the decision chose.
  * ``stream``           — a one-shot snapshot of a streaming handle
                           (``repro_torch.stream``) bootstrapped over the
                           cached plain fdbscan index; :func:`stream_handle`
                           and :func:`tenant_handles` return live handles
                           over the same index.
  * ``sharded``          — shard-local trees over a mesh's data axis with
                           an eps-halo exchange of traveling queries
                           (``repro_torch.distributed``); ``mesh=`` with
                           more than one shard routes auto dispatch here.

Every walk runs where the points are: on a CUDA device each walk of every
tree backend, and every level walk of a streaming handle, is the walk
kernel, so the tree backends differ on the card only in their index; on
the CPU each walk is the plain engine.

``plan()`` performs the (cacheable) decision + index build; ``dbscan()``
executes a plan. Plans are memoized in a small LRU keyed by point-set
content hash, device and parameters, with the eps-independent fdbscan
index shared across all eps/min_pts entries of the same point set.

Both are instrumented (:mod:`repro_torch.obs`) at the reference's points:
``plan``/``build``/``dbscan`` spans and the plan, cache, index-build and
run counters. The port adds the ``plan.hash`` span (the content hash,
inside ``plan``), the ``build.grid``/``build.tree``/``build.pack`` spans
inside each ``build``, and counts its host reads (``obs.syncs``). With no
collector installed each point is a ``None`` check.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names, syncs
from repro_torch.obs import trace as obs_trace

from . import fdbscan, grid, lbvh, tune
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


def _maybe_kernel(p: "Plan", algorithm: str, eps: float,
                  min_pts: int) -> "Plan":
    """Name an auto tree decision on the card as the walk-kernel backend,
    with its tuner state. Every walk on a CUDA index is the kernel already;
    the plan keeps the index the decision chose and records why."""
    if algorithm != "auto" or p.tree is None or not _accel(p.device):
        return p
    stats = dict(p.stats)
    stats["reason"] = (stats.get("reason", "") +
                       "; CUDA device: hand-written walk kernel")
    return _attach_tune(p._replace(backend="pallas-tree", stats=stats),
                        eps, min_pts)


def _attach_tune(p: "Plan", eps: float, min_pts: int) -> "Plan":
    """Resolve a pallas-tree plan's tuner state (``core.tune``).

    The decision rides in the plan LRU beside the eps-independent index,
    so repeat runs reuse it (and the depth calibration the first run
    makes). ``REPRO_TUNE=search`` configs are also cached under the
    bucketed :func:`core.tune.stats_key` (and the device type), so
    equal-shaped plans share one measured search.
    """
    if p.backend != "pallas-tree" or p.tree is None:
        return p
    m = tune.mode()
    if m == "search":
        skey = ("tune-config", p.device.type,
                tune.stats_key(p.segs, eps, min_pts))
        hit = _cache_get(skey)
        if hit is None:
            with obs_trace.span("tune.search"):
                hit = _cache_put(skey, tune.search(
                    p.segs, p.tree, eps, min_pts, walk_index=p.walk_index))
            obs_metrics.inc("tune_searches_total")
        cfg, info = hit
        state = tune.TuneState(cfg)
        state.info = dict(info)
    else:
        state = tune.TuneState(tune.config_for(p.segs, p.tree, eps,
                                               min_pts, m))
    stats = dict(p.stats)
    stats["tuned_config"] = state.describe()
    return p._replace(tune=state, stats=stats)


class Plan(NamedTuple):
    """A resolved backend choice plus the (reusable) index that drove it.

    backend: one of "fdbscan", "fdbscan-densebox", "pallas-tree", "tiled",
        "stream", "sharded".
    segs / tree: the segment index and its LBVH (None for the index-free
        tiled backend and for the sharded backend, whose shards build
        their own, and tree is None below two segments); a stream plan
        carries the plain fdbscan index its handles bootstrap from.
    stats: occupancy/size stats behind the choice; ``stats["reason"]``
        states why this backend won; pallas-tree plans also record
        ``stats["tuned_config"]``.
    device: where the index lives and the clustering runs.
    walk_index: the index's packed layout for the walk kernel
        (``repro_torch.kernels.walkpack.WalkIndex``), built with the index
        on a CUDA device; None on the CPU and without a tree.
    tune: the plan's ``core.tune.TuneState`` (pallas-tree only): the
        per-phase engine/lane-tile/unroll/order decision plus the lazily
        calibrated walk-depth oracle, cached with the plan.
    """
    backend: str
    segs: grid.Segments | None
    tree: lbvh.Tree | None
    stats: dict
    device: torch.device
    walk_index: Any = None
    tune: Any = None


def clear_cache() -> None:
    _plan_cache.clear()


def cache_info() -> dict:
    return {"entries": len(_plan_cache), "max": _CACHE_MAX}


def _points_key(points: torch.Tensor) -> str:
    arr = np.ascontiguousarray(syncs.read(points.detach(), "dispatch.hash"))
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


def _mesh_ndev(mesh, axis: str) -> int:
    """Shards along ``axis`` (1 when the mesh lacks it — a mesh without a
    data axis never routes auto dispatch to the sharded backend); with no
    mesh, those of the default mesh (``distributed.ring_dbscan.
    default_mesh``: the ``torch.distributed`` world, else one)."""
    from repro_torch.distributed import sharding
    if mesh is None:
        from repro_torch.distributed.ring_dbscan import default_mesh
        mesh = default_mesh(axis)
    return sharding._axis_size(mesh, axis)


def _tree_of(segs: grid.Segments):
    if segs.n_segments < 2 or segs.n_points < 2:
        return None
    with obs_trace.span("build.tree") as sp:
        tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
        sp.watch(tree)
    return tree


def _walk_index_of(segs: grid.Segments, tree):
    """The walk kernel's packed layout of the index, for a tree on a CUDA
    device (the only place the kernel reads it) in d = 2 or 3 (the only
    dimensions it takes; a walk raises for others); else None."""
    if (tree is None or not _accel(segs.pts.device)
            or segs.pts.shape[1] not in (2, 3)):
        return None
    from repro_torch.kernels.walkpack import pack_index
    with obs_trace.span("build.pack") as sp:
        walk_index = pack_index(tree, segs)
        sp.watch(walk_index)
    return walk_index


def _fdbscan_plan(points, pkey: str, stats: dict) -> Plan:
    """Plain-FDBSCAN plan; the index is eps-independent and shared across
    every (eps, min_pts) plan for the same point set."""
    base_key = (pkey, "fdbscan-index")
    cached = _cache_get(base_key)
    if cached is None:
        with obs_trace.span("build", index="fdbscan") as sp:
            with obs_trace.span("build.grid") as sg:
                segs = grid.build_segments_fdbscan(points)
                sg.watch(segs)
            tree = _tree_of(segs)
            walk_index = _walk_index_of(segs, tree)
            sp.watch(segs, tree, walk_index)
        obs_metrics.inc("dispatch_index_builds_total", index="fdbscan")
        cached = _cache_put(base_key, (segs, tree, walk_index))
    segs, tree, walk_index = cached
    return Plan("fdbscan", segs, tree, stats, points.device, walk_index)


def plan(points, eps: float, min_pts: int, algorithm: str = "auto",
         mesh=None, axis: str = "data", *, device=None) -> Plan:
    """Choose a backend and build (or fetch) its index.

    The densebox grid build is reused as the density probe: its dense-point
    fraction decides densebox-vs-plain, and on a densebox decision the very
    same segments become the index. On a CUDA device an auto tree decision
    becomes the ``pallas-tree`` (walk kernel) backend. An active ``mesh``
    routes to the sharded tree path, whose shards build their own indexes
    at run time: nothing to cache here beyond the decision.

    Instrumented: with a collector installed, planning is bracketed by a
    ``plan`` span (the content hash gets a nested ``plan.hash`` span, index
    builds a nested ``build`` span) and reports plan and cache-hit counters
    per backend.

    Args:
        points: (n, d) points (array-like or tensor; computed in float32).
        eps: DBSCAN radius (non-negative).
        min_pts: DBSCAN density threshold (the query point counts).
        algorithm: one of :data:`ALGORITHMS`; ``"auto"`` probes and picks.
        mesh: optional ``repro_torch.distributed.sharding.LocalMesh`` or
            ``GroupMesh`` (``repro_torch.launch.mesh`` makes them); with an
            ``axis`` of more than one shard it routes auto dispatch to the
            sharded backend.
        axis: the mesh axis points are sharded over (default ``"data"``).
        device: where to build and run; default the current CUDA device
            (``RuntimeError`` if there is none).

    Raises:
        ValueError: unknown ``algorithm``; negative ``eps``; malformed
            ``points`` (see :func:`check_points`); ``mesh=`` combined with
            a single-device algorithm; a sharded request whose mesh lacks
            ``axis``; a stream request with d not in (2, 3).
    """
    with obs_trace.span("plan", algorithm=algorithm) as sp:
        p = _plan_impl(points, eps, min_pts, algorithm, mesh, axis, device)
        sp.watch(p.segs, p.tree)
    obs_metrics.inc("dispatch_plans_total", backend=p.backend)
    return p


def _plan_impl(points, eps: float, min_pts: int, algorithm: str, mesh,
               axis: str, device) -> Plan:
    """The planning decision body; :func:`plan` wraps it in the span and
    counter instrumentation."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if eps < 0:
        raise ValueError(f"eps must be non-negative; got {eps}"
                         " (a negative eps would be squared away silently)")
    if mesh is not None and algorithm not in ("auto", "sharded"):
        raise ValueError(
            f"mesh= is incompatible with algorithm={algorithm!r}: the "
            f"{algorithm} backend is single-device and would silently "
            "ignore it (use algorithm='sharded' or 'auto' to shard)")
    n, d = check_points(points).shape
    dev = resolve_device(device)
    if mesh is not None and axis not in mesh.axis_names:
        if algorithm == "sharded":
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        mesh = None  # a mesh without the data axis cannot shard points
    if (algorithm == "sharded"
            or (algorithm == "auto" and mesh is not None
                and _mesh_ndev(mesh, axis) > 1)):
        # sharded plans carry no index and depend only on the mesh, so no
        # point-content hash (an O(n) host transfer) and no cache needed
        return Plan("sharded", None, None,
                    {"n": n, "d": d, "ndev": _mesh_ndev(mesh, axis),
                     "mesh": mesh, "axis": axis,
                     "reason": ("explicit" if algorithm == "sharded"
                                else "mesh active: shard-local trees")},
                    dev)
    points = as_points(points, dev)
    with obs_trace.span("plan.hash"):
        pkey = _points_key(points)
    key = (pkey, float(eps), int(min_pts), algorithm)
    hit = _cache_get(key)
    if hit is not None:
        obs_metrics.inc("dispatch_plan_cache_hits_total")
        return hit
    obs_metrics.inc("dispatch_plan_cache_misses_total")

    stats: dict = {"n": n, "d": d}
    if algorithm == "stream":
        # the streaming handle wraps the plain fdbscan index, which is
        # eps-independent — every (eps, min_pts) stream plan for the same
        # point set shares one cached index build (and its packed layout)
        if d not in (2, 3):
            raise ValueError(f"streaming index needs d in (2, 3); got {d}")
        stats["reason"] = "explicit: streaming tiered index"
        return _cache_put(key, _fdbscan_plan(points, pkey, stats)._replace(
            backend="stream"))
    if algorithm == "tiled" or (algorithm == "auto" and n <= TILED_MAX_POINTS):
        stats["reason"] = ("explicit" if algorithm == "tiled"
                           else f"n <= {TILED_MAX_POINTS}: tiles win")
        return _cache_put(key, Plan("tiled", None, None, stats,
                                    points.device))

    if algorithm == "pallas-tree":
        # the walk kernel over the plain (eps-independent, cached) fdbscan
        # index — the explicit form of the auto decision on the card
        stats["reason"] = "explicit: hand-written walk kernel"
        return _cache_put(key, _attach_tune(
            _fdbscan_plan(points, pkey, stats)._replace(
                backend="pallas-tree"), eps, min_pts))

    if algorithm == "fdbscan" or d not in (2, 3):
        stats["reason"] = ("explicit" if algorithm == "fdbscan"
                           else "no eps-grid for this dimensionality")
        return _cache_put(key, _maybe_kernel(
            _fdbscan_plan(points, pkey, stats), algorithm, eps, min_pts))

    # eps-grid build: density probe and (potentially) the index itself,
    # whose tree and packed layout are built inside the same span
    with obs_trace.span("build", index="densebox") as sp:
        with obs_trace.span("build.grid") as sg:
            segs = grid.build_segments_densebox(points, eps, min_pts)
            sg.watch(segs)
        dense_frac = syncs.read(segs.dense_pt.float().mean(),
                                "dispatch.dense_fraction")
        densebox = (algorithm == "fdbscan-densebox"
                    or dense_frac >= DENSE_FRACTION_MIN)
        tree = walk_index = None
        if densebox:
            tree = _tree_of(segs)
            walk_index = _walk_index_of(segs, tree)
        sp.watch(segs, tree, walk_index)
    obs_metrics.inc("dispatch_index_builds_total", index="densebox")
    stats.update(dense_fraction=dense_frac, n_segments=segs.n_segments)
    if densebox:
        stats["reason"] = ("explicit" if algorithm == "fdbscan-densebox"
                           else f"dense_fraction >= {DENSE_FRACTION_MIN}")
        return _cache_put(key, _maybe_kernel(
            Plan("fdbscan-densebox", segs, tree, stats, points.device,
                 walk_index), algorithm, eps, min_pts))
    stats["reason"] = f"dense_fraction < {DENSE_FRACTION_MIN}: plain tree"
    return _cache_put(key, _maybe_kernel(
        _fdbscan_plan(points, pkey, stats), algorithm, eps, min_pts))


def dbscan(points, eps: float, min_pts: int, *, algorithm: str = "auto",
           star: bool = False, frontier: bool = True, mesh=None,
           axis: str = "data", query_plan: Plan | None = None,
           device=None) -> fdbscan.DBSCANResult:
    """DBSCAN with automatic backend selection (the unified entry point).

    ``query_plan`` short-circuits planning entirely — pass the result of a
    previous :func:`plan` call *for the same point set* to amortize the
    index build across runs (the plan's index, not ``points``, is what a
    tree backend clusters; the run happens on the plan's device).
    ``mesh`` (a mesh with a data axis) routes auto dispatch to the sharded
    tree path.

    Args:
        points: (n, d) points (array-like or tensor).
        eps: DBSCAN radius (non-negative).
        min_pts: DBSCAN density threshold (the query point counts, so a
            point with ``min_pts - 1`` neighbors is core).
        algorithm: backend request, see :func:`plan`.
        star: DBSCAN* variant — no border points, non-core points are
            noise (not supported by the sharded backend).
        frontier: restrict label sweeps to the changed-point frontier
            (exact, default True); only for the single-device tree
            backends.
        mesh / axis: multi-shard routing, see :func:`plan`.
        query_plan: a previous :func:`plan` result for the same points.
        device: see :func:`plan`.

    Returns:
        A :class:`repro_torch.core.fdbscan.DBSCANResult` whose tensors live
        on the run's device; ``labels[i] == -1`` marks noise, ``backend``
        names the backend that actually ran.

    Raises:
        RuntimeError: no CUDA device and no ``device`` given.
        ValueError: invalid parameters (see :func:`plan`), or ``frontier``
            combined with the tiled, stream or sharded backend, which
            would ignore it.
        NotImplementedError: ``star=True`` on the sharded backend.
    """
    n = check_points(points).shape[0]
    if query_plan is not None:
        p = query_plan
    else:
        p = plan(points, eps, min_pts, algorithm, mesh, axis, device=device)
    if p.backend in ("tiled", "stream", "sharded") and frontier is not True:
        raise ValueError(
            f"frontier={frontier!r} is incompatible with the {p.backend} "
            "backend: frontier restriction only applies to the single-"
            "device tree-sweep backends and would silently be ignored "
            "(drop the kwarg, or pick "
            "algorithm='fdbscan'/'fdbscan-densebox')")
    with obs_trace.span("dbscan", backend=p.backend, n=n) as sp:
        if p.backend == "sharded":
            from repro_torch.distributed.ring_dbscan import \
                tree_dbscan_sharded
            if star:
                raise NotImplementedError(
                    "sharded backend has no DBSCAN* mode")
            res = tree_dbscan_sharded(
                points, eps, min_pts, mesh=p.stats.get("mesh", mesh),
                axis=p.stats.get("axis", axis),
                device=p.device)._replace(backend="sharded")
        elif p.backend == "stream":
            # one-shot execution of a stream plan: bootstrap a handle over
            # the plan's (cached, eps-independent) index and materialize
            # labels
            from repro_torch.stream import StreamingDBSCAN
            h = StreamingDBSCAN(points, eps, min_pts,
                                index=(p.segs, p.tree, p.walk_index),
                                device=p.device)
            res = h.snapshot(star=star)
        elif p.backend == "tiled":
            from repro_torch.kernels import ops
            res = ops.dbscan_tiled(as_points(points, p.device), eps,
                                   min_pts, star=star)
        else:
            if p.tune is not None:
                # the decision in the metrics snapshot: an info-style gauge
                # whose labels carry the per-phase choice
                desc = p.tune.describe()
                for ph in ("first_pass", "sweep", "border"):
                    c = desc[ph]
                    obs_metrics.set_gauge(
                        "tuned_config_info", 1.0, phase=ph,
                        engine=c["engine"], lane_tile=str(c["lane_tile"]),
                        unroll=str(c["unroll"]), reorder=c["reorder"],
                        source=desc["source"])
            res = fdbscan.cluster_from_index(p.segs, p.tree, eps, min_pts,
                                             star=star, frontier=frontier,
                                             backend=p.backend, tune=p.tune,
                                             walk_index=p.walk_index)
        sp.watch(res.labels, res.core_mask)
    obs_metrics.inc("dbscan_runs_total", backend=p.backend)
    if obs_metrics.active() is not None:
        # a pending device sum, read with the registry: no sync here
        obs_metrics.inc(names.DBSCAN_POINTS, n, backend=p.backend)
        obs_metrics.inc(names.DBSCAN_DENSE_POINTS,
                        0 if p.segs is None else p.segs.dense_pt.sum(),
                        backend=p.backend)
    obs_metrics.observe("dbscan_sweeps", res.n_sweeps, backend=p.backend)
    return res


def stream_handle(points, eps: float, min_pts: int, *,
                  window: int | None = None,
                  wal=None, checkpoint_path: str | None = None,
                  checkpoint_every: int = 0, device=None, **kwargs):
    """Build a :class:`repro_torch.stream.StreamingDBSCAN` handle over
    ``points``.

    Goes through :func:`plan`, so the handle's main tree is the *cached*
    eps-independent fdbscan index, with its packed layout for the walk
    kernel — building handles (or running batch ``dbscan``) for several
    ``eps``/``min_pts`` values over the same point set shares one index
    build.

    The durability options make the handle crash-safe (DESIGN.md §10):
    with ``wal`` every insert is durably logged before it is applied, and
    with ``checkpoint_path`` (+ ``checkpoint_every``) the full state is
    atomically serialized every K index merges. After a crash,
    ``StreamingDBSCAN.restore(checkpoint_path, wal=wal)`` rebuilds the
    handle from the last checkpoint plus a WAL replay. The files are the
    reference's format: either package restores the other's.

    Args:
        points: (n, d) initial points, d in (2, 3).
        eps: DBSCAN radius (positive).
        min_pts: DBSCAN density threshold.
        window: optional sliding-window size — every insert auto-expires
            points whose insert id falls below ``n_points - window``
            (insert-order watermark; see ``StreamingDBSCAN.expire``).
        wal: optional write-ahead-log path (or a prebuilt
            ``repro_torch.stream.durability.WriteAheadLog``).
        checkpoint_path: optional checkpoint file for
            :meth:`StreamingDBSCAN.checkpoint` and the auto policy.
        checkpoint_every: auto-checkpoint after every K merges (0 = off).
        device: where the handle lives and walks; default the current
            CUDA device (``RuntimeError`` if there is none).
        **kwargs: passed to the handle (e.g. ``merge_ratio``, the
            delta/main size ratio that triggers a full index merge, or
            ``buffer_max``/``growth``, the tiered-compaction knobs).

    Returns:
        A live ``StreamingDBSCAN`` handle exposing ``insert`` /
        ``delete`` / ``expire`` / ``query`` / ``snapshot`` / ``merge`` /
        ``compact`` / ``checkpoint``; after any interleaving of inserts,
        deletes, expiries, merges and compactions, ``snapshot()`` is
        component-identical to batch :func:`dbscan` on exactly the
        surviving points.

    Raises:
        RuntimeError: no CUDA device and no ``device`` given.
        ValueError: malformed ``points`` (empty, NaN/Inf, d outside
            (2, 3)), negative ``eps``, or inserts that change
            dimensionality (raised by the handle).
        repro_torch.stream.durability.WALError: ``wal`` names a file with
            leftover records from a crashed run (restore it instead).
    """
    from repro_torch.stream import StreamingDBSCAN
    p = plan(points, eps, min_pts, algorithm="stream", device=device)
    return StreamingDBSCAN(points, eps, min_pts,
                           index=(p.segs, p.tree, p.walk_index),
                           window=window, wal=wal,
                           checkpoint_path=checkpoint_path,
                           checkpoint_every=checkpoint_every,
                           device=p.device, **kwargs)


def tenant_handles(points, tenants: dict, *, device=None) -> dict:
    """Build one streaming handle per tenant over ONE shared index build.

    ``tenants`` maps tenant name -> kwargs for :func:`stream_handle`
    (``eps`` and ``min_pts`` required; durability/window/compaction
    options per tenant). The eps-independent part of the bootstrap — the
    Morton sort + LBVH over ``points`` and its packed layout — is cached
    under the point set's content hash, so N tenants cost one index build
    plus N eps-dependent clusterings; ``dispatch_index_builds_total``
    moves by exactly one however many tenants share the point set.
    ``device`` applies to every tenant (default the current CUDA device).
    """
    if not tenants:
        raise ValueError("tenant_handles needs at least one tenant")
    handles = {}
    with obs_trace.span("plan.tenants", n_tenants=len(tenants)):
        for name, kw in tenants.items():
            kw = dict(kw)
            try:
                eps = kw.pop("eps")
                min_pts = kw.pop("min_pts")
            except KeyError as e:
                raise ValueError(f"tenant {name!r}: missing {e} in spec")
            handles[name] = stream_handle(points, eps, min_pts,
                                          device=device, **kw)
    return handles
