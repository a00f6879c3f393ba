"""FDBSCAN and FDBSCAN-DenseBox — the paper's two tree-based algorithms.

Two bulk phases over a segment BVH:

  fused first pass: ONE traversal computes the neighbor count *and* a
      min-neighbor-label candidate, collapsing core-point preprocessing and
      the first main-phase sweep. The candidate is validated against the
      core mask after the pass (a candidate gathered from a non-core
      neighbor is discarded), so the hook only ever merges genuine
      core-core pairs.

  main: min-label propagation sweeps fused into the traversal (hook) +
      pointer jumping, iterated to a fixpoint. Sweeps restrict their
      gathers to the *frontier* — the points whose label changed last
      sweep. Because labels decrease monotonically under a min hook, the
      restriction is exact, so the first no-change sweep certifies the
      fixpoint. Border points are assigned in one final gather and never
      propagate labels (no cluster bridging by construction).

Every walk goes through ``repro_torch.kernels.traverse.traverse``: the
plain engine for an index on the CPU, the walk kernel for one on the card.
Memory is O(n + m): neighbor lists are never materialized.

Instrumented (:mod:`repro_torch.obs`) at the reference's points: the
``traverse`` (first pass), ``sweep``, ``border`` and ``finalize`` spans and
the walks' ``traversal_evals_total``/``traversal_iters_total`` counters,
labelled by phase and engine (``"reference"`` for the plain engine,
``"cuda"`` for the walk kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from . import grid, lbvh, traversal, unionfind

INT_MAX = traversal.INT_MAX

# The reference's padding floor: the smallest bucket of _pad_size.
_PAD_MIN = 64
# Floor of the frontier size below which a sweep re-traverses only the
# queries near a changed point (the padding floor sets the same threshold
# in the reference).
_SMALL_FRONTIER_MIN = _PAD_MIN


class DBSCANResult(NamedTuple):
    """The result record every DBSCAN backend returns.

    labels: (n,) int32 cluster id in [0, n_clusters), or -1 for noise,
        in the caller's original point order. Cluster ids are compact and
        deterministic (derived from each component's smallest original
        index), so equal inputs give byte-equal labels across runs.
    core_mask: (n,) bool — the point has >= min_pts neighbors within eps
        (itself included).
    n_clusters: number of distinct non-noise labels.
    n_sweeps: main-phase label sweeps until fixpoint, including the fused
        first pass.
    n_traversals: total tree walks this run (``n_sweeps + 1`` for the
        tree backends with border assignment; 0 for the tiled backend).
    backend: the resolved backend name that produced this result.
    """
    labels: torch.Tensor
    core_mask: torch.Tensor
    n_clusters: int
    n_sweeps: int
    n_traversals: int = -1
    backend: str = ""


def _walk(*args, **kwargs):
    from repro_torch.kernels.traverse import traverse
    return traverse(*args, **kwargs)


def _engine_name(segs: grid.Segments) -> str:
    """Metric label for the walks' engine: the walk kernel on the card,
    the plain engine (the reference's label for its own) elsewhere."""
    return "cuda" if segs.pts.device.type == "cuda" else "reference"


def _record_trace(phase: str, engine: str, tr) -> None:
    """Fold a walk's work counters into the installed metrics registry.
    Reading them syncs the device, so this is gated on an installed
    registry — with none, the walk's result is never touched."""
    if obs_metrics.active() is None:
        return
    obs_metrics.inc("traversal_evals_total", float(tr.evals.sum()),
                    phase=phase, engine=engine)
    obs_metrics.inc("traversal_iters_total", float(tr.iters.sum()),
                    phase=phase, engine=engine)


def _segment_max_bool(flags, segs: grid.Segments):
    return grid._segment_reduce(flags.to(torch.int32), segs.seg_of_point,
                                segs.n_segments, "amax").to(torch.bool)


def _unify_dense(labels, segs: grid.Segments):
    """Equalize labels within dense segments (paper: one UNION per cell)."""
    seg_min = grid._segment_reduce(labels, segs.seg_of_point,
                                   segs.n_segments, "amin")
    dense_lab = seg_min[segs.seg_of_point]
    return torch.where(segs.dense_pt, torch.minimum(labels, dense_lab), labels)


def _fused_first_pass(tree, segs, eps, min_pts: int, *, walk_index=None):
    """(core, labels0, vals0, absorbed, trace) from a single traversal."""
    n = segs.n_points
    dev = segs.pts.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    # Candidate labels as if every point were core: own index, unified
    # within dense cells. Every gathered value is therefore a sorted index
    # whose core status can be checked once counts are known.
    vals0 = _unify_dense(idx, segs)
    # hits excludes the query itself: |N_eps(q)| >= min_pts <=> hits >= mp-1,
    # so the count may saturate at min_pts - 1 (re-arming the dense
    # short-circuit for saturated lanes — the fused early exit).
    tr = _walk(tree, segs,
               traversal.intersects(traversal.sphere(eps)),
               traversal.CountMinLabelVisitor(
                   vals0, torch.ones(n, dtype=torch.bool, device=dev),
                   cap=min_pts - 1), walk_index=walk_index)
    core = segs.dense_pt | (tr.hits >= min_pts - 1)
    # Validate the candidate: vals0 maps loose points to themselves and
    # dense points to a dense (hence core) member, so core[cand] holds iff
    # the contributing neighbor is core — a sound hook.
    cand = tr.acc
    cand_ok = core[torch.clamp(cand, 0, n - 1)]
    labels0 = torch.where(core, torch.where(cand_ok, cand, vals0), INT_MAX)
    labels0 = torch.where(core, _unify_dense(labels0, segs), labels0)
    labels0 = torch.where(core, unionfind.jump_to_fixpoint(
        torch.where(core, labels0, idx)), labels0)
    # A core query with a valid candidate has absorbed the min over *every*
    # neighbor's initial value; in the next sweep it only needs to gather
    # from points whose label changed since init.
    absorbed = cand_ok & core
    return core, labels0, vals0, absorbed, tr


def _pad_size(k: int) -> int:
    """The reference's pad length for ``k`` lanes or points: quarter-power-
    of-two buckets, at least :data:`_PAD_MIN`. The port compiles nothing
    per shape and pads no lanes, but the streaming index pads its levels to
    these sizes (so a level is the same index in both packages) and names
    its walk signatures by them."""
    size = _PAD_MIN
    while size < k:
        size *= 2
    if size > _PAD_MIN:
        quarter = size // 4
        size = -(-k // quarter) * quarter
    return max(size, _PAD_MIN)


def _compact_ids(mask: torch.Tensor) -> torch.Tensor:
    """Active sorted-point ids (int32), exactly as many as the mask sets.

    The reference pads these to bucketed lengths to bound its compiled
    shapes; eager PyTorch and the ctypes-launched kernel compile nothing
    per shape, so no lane here is padding."""
    return torch.nonzero(mask).flatten().to(torch.int32)


def _scatter_back(n: int, ids, acc):
    """Full-width (n,) int32 of the lanes' results; INT_MAX elsewhere."""
    gathered = torch.full((n,), INT_MAX, dtype=torch.int32, device=ids.device)
    gathered[ids.long()] = acc
    return gathered


def _gather_minlabel(tree, segs, eps, labels, gather_mask, ids,
                     node_mask=None, walk_index=None):
    """One (possibly compacted/pruned) min-label sweep, full-width output."""
    tr = _walk(tree, segs,
               traversal.intersects(traversal.sphere(eps), ids=ids),
               traversal.MinLabelVisitor(labels, gather_mask),
               node_mask=node_mask, walk_index=walk_index)
    return _scatter_back(segs.n_points, ids, tr.acc), tr


def _post_sweep(tree, segs, labels, core, ids, acc):
    """Scatter-back + hook + dense unification + pointer jumping + change
    detection + next sweep's node flags."""
    n = labels.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=labels.device)
    gathered = _scatter_back(n, ids, acc)
    new = unionfind.hook(labels, gathered, mask=core)
    new = _unify_dense(torch.where(core, new, labels), segs)
    new = torch.where(core, unionfind.jump_to_fixpoint(
        torch.where(core, new, idx)), new)
    changed = (new != labels) & core
    return new, changed, _frontier_node_mask(tree, segs, changed)


def _frontier_node_mask(tree, segs, changed):
    """Per-node 'subtree holds a changed point' flag for descent pruning."""
    return lbvh.propagate_leaf_flags(tree, _segment_max_bool(changed, segs))


# A pair within eps spans at most ceil(eps / cell_edge) cells per axis;
# cell_edge >= eps/sqrt(d) (d <= 3), so radius 2 always covers.
_CELL_DILATE = 2


def _cell_keys(pts, eps: float) -> torch.Tensor:
    """int64 eps-grid cell key per (sorted) point, for the frontier filter."""
    c, _ = grid._cell_coords(pts, eps)
    if c.shape[1] == 2:
        return (c[:, 0] << 21) | c[:, 1]
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def _near_changed(keys: torch.Tensor, d: int, changed: torch.Tensor
                  ) -> torch.Tensor:
    """Points whose eps-cell is within the dilation radius of a changed
    point's cell — a sound superset of 'has a changed point within eps'."""
    changed_keys = torch.unique(keys[changed])
    r = range(-_CELL_DILATE, _CELL_DILATE + 1)
    # arithmetic (not bitwise) composition: offsets have negative components
    if d == 2:
        offs = [(dx << 21) + dy for dx in r for dy in r]
    else:
        offs = [(dx << 42) + (dy << 21) + dz
                for dx in r for dy in r for dz in r]
    offs = torch.tensor(offs, dtype=torch.int64, device=keys.device)
    dilated = (changed_keys[:, None] + offs).ravel()
    return torch.isin(keys, dilated)


def _sweep_to_fixpoint(tree, segs, eps, core, labels0, *,
                       frontier: bool = True, collect_stats: bool = False,
                       fused_init=None, walk_index=None):
    """Hook+jump sweeps until the core-core components stabilize.

    Frontier restriction: labels only ever decrease and the hook is a
    monotone min, so a point already holds everything it gathered in
    earlier sweeps — gathering over *only the points whose label changed
    last sweep* is exact, not a heuristic. Each frontier sweep therefore
    (a) masks the gather to changed points and (b) prunes tree descent into
    subtrees containing no changed point. Labels and sweep counts are
    identical to full sweeps; only the work shrinks.

    Returns (labels, sweeps, stats) with per-sweep frontier sizes and
    loop-trip totals.
    """
    n = segs.n_points
    d = segs.pts.shape[1]
    n_core = int(core.sum())
    # Query-side restriction only pays once the frontier is genuinely
    # small; above this the cell filter is overhead for nothing.
    small = max(_SMALL_FRONTIER_MIN, n_core // 4)
    labels = labels0
    ids_core = _compact_ids(core)  # default: every core point gathers
    ids = ids_core
    gather_mask = core            # sweep 1 is full: nothing gathered yet
    # every gather mask is a subset of core, so subtrees holding only
    # non-core points (noise regions) are prunable from sweep one on
    node_mask_core = _frontier_node_mask(tree, segs, core)
    node_mask = node_mask_core
    # eps <= 0 is degenerate (no grid): skip the cell filter, keep the
    # (still exact) gather-mask + node-mask frontier restriction
    cell_keys = _cell_keys(segs.pts, eps) if frontier and eps > 0 else None
    dual = {}
    gather_wide = None            # wide lanes' gather mask (split sweep 1)
    if frontier and fused_init is not None:
        # Split first sweep: queries that absorbed every initial value in
        # the fused pass gather changed-since-init points only (narrow);
        # the validation-rejected minority gathers the full core set
        # (wide). One walk, per-lane mask choice — exact either way.
        vals0, absorbed = fused_init
        changed0 = core & (labels0 != vals0)
        wide = core & ~absorbed
        if cell_keys is not None and int(changed0.sum()) <= small:
            near0 = (_near_changed(cell_keys, d, changed0)
                     if bool(changed0.any()) else torch.zeros_like(core))
            ids = _compact_ids(wide | (core & near0))
            lane_wide = wide[ids.long()]
            gather_mask = changed0
            gather_wide = core
            dual = dict(wide_lanes=lane_wide, node_mask_wide=node_mask_core)
            node_mask = _frontier_node_mask(tree, segs, changed0)
    sweeps = 0
    stats = {"frontier_per_sweep": [], "active_per_sweep": [],
             "iters_per_sweep": [], "evals_per_sweep": []}
    engine = _engine_name(segs)
    while True:
        with obs_trace.span("sweep", i=sweeps + 1, engine=engine) as sp:
            tr = _walk(tree, segs,
                       traversal.intersects(traversal.sphere(eps), ids=ids),
                       traversal.MinLabelVisitor(labels, gather_mask,
                                                 mask_wide=gather_wide),
                       node_mask=node_mask, walk_index=walk_index, **dual)
            dual = {}             # only the first sweep may be split
            gather_wide = None
            new, changed, changed_flags = _post_sweep(tree, segs, labels,
                                                      core, ids, tr.acc)
            sp.watch(new, changed)
        _record_trace("sweep", engine, tr)
        sweeps += 1
        if collect_stats:
            stats["frontier_per_sweep"].append(int(gather_mask.sum()))
            stats["active_per_sweep"].append(ids.shape[0])
            stats["iters_per_sweep"].append(int(tr.iters.sum()))
            stats["evals_per_sweep"].append(int(tr.evals.sum()))
        labels = new
        n_changed = int(changed.sum())
        if n_changed == 0:
            break
        if frontier:
            # gather only from changed points; prune unchanged subtrees;
            # and, once the frontier is small, re-traverse only queries
            # whose eps-cell neighborhood holds a changed point (anyone
            # else provably cannot improve)
            gather_mask = changed
            node_mask = changed_flags
            if cell_keys is not None and n_changed <= small:
                ids = _compact_ids(core & _near_changed(cell_keys, d,
                                                        changed))
            else:
                ids = ids_core
    return labels, sweeps, stats


def _assign_borders(tree, segs, eps, core, core_labels, *,
                    walk_index=None):
    """Borders take the min adjacent core root; isolated non-core -> noise.

    Traverses a compacted non-core query set (usually a small minority),
    pruning subtrees that hold no core point (nothing to gather there).
    """
    ids = _compact_ids(~core)
    vals = torch.where(core, core_labels, INT_MAX)
    gathered, tr = _gather_minlabel(tree, segs, eps, vals, core, ids,
                                    node_mask=_frontier_node_mask(tree, segs,
                                                                  core),
                                    walk_index=walk_index)
    _record_trace("border", _engine_name(segs), tr)
    labels = torch.where(core, core_labels, gathered)
    return torch.where(labels == INT_MAX, -1, labels)


def _finalize(labels_sorted, order, n):
    """Map sorted-space representative labels to compact original-order
    ids; returns (labels, n_clusters)."""
    dev = labels_sorted.device
    out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out[order.long()] = labels_sorted.to(torch.int32)
    # representative (sorted index) -> original index for determinism
    rep_orig = torch.where(out >= 0, order[torch.clamp(out, 0, n - 1)], -1)
    uniq, inv = torch.unique(rep_orig, sorted=True, return_inverse=True)
    has_noise = bool((rep_orig == -1).any())
    compact = inv - int(has_noise)
    compact = torch.where(rep_orig == -1, -1, compact)
    n_clusters = int((uniq >= 0).sum())
    return compact.to(torch.int32), n_clusters


def cluster_from_index(segs: grid.Segments, tree, eps: float, min_pts: int,
                       *, star: bool = False, frontier: bool = True,
                       backend: str = "", with_stats: bool = False,
                       walk_index=None):
    """Run the clustering phases over a prebuilt (segments, tree) index.

    ``tree`` may be None when ``segs.n_segments == 1`` (single dense cell)
    or ``n == 1``: both return before any walk. Every walk runs on the
    index's device (the walk kernel on the card, the plain engine on the
    CPU); ``backend`` only names the result. ``walk_index`` is the index's
    packed layout for the walk kernel (``dispatch.Plan.walk_index``); on
    the card it is packed here, once for all walks, when not given.
    """
    n = segs.n_points
    dev = segs.pts.device
    stats: dict = {}
    if n == 1:
        noise = min_pts > 1
        res = DBSCANResult(
            labels=torch.tensor([-1 if noise else 0], dtype=torch.int32,
                                device=dev),
            core_mask=torch.tensor([not noise], device=dev),
            n_clusters=0 if noise else 1, n_sweeps=0, n_traversals=0,
            backend=backend)
        return (res, stats) if with_stats else res

    if segs.n_segments == 1:
        # Everything inside one dense cell: one cluster, all core, 0 sweeps.
        res = DBSCANResult(labels=torch.zeros(n, dtype=torch.int32,
                                              device=dev),
                           core_mask=torch.ones(n, dtype=torch.bool,
                                                device=dev),
                           n_clusters=1, n_sweeps=0, n_traversals=0,
                           backend=backend)
        return (res, stats) if with_stats else res

    if walk_index is None and dev.type == "cuda":
        from repro_torch.kernels.walkpack import pack_index
        walk_index = pack_index(tree, segs)
    engine = _engine_name(segs)
    with obs_trace.span("traverse", phase="first_pass", engine=engine) as sp:
        core, labels0, vals0, absorbed, first = _fused_first_pass(
            tree, segs, eps, min_pts, walk_index=walk_index)
        sp.watch(core, labels0)
    _record_trace("first_pass", engine, first)
    core_labels, loop_sweeps, sweep_stats = _sweep_to_fixpoint(
        tree, segs, eps, core, labels0, frontier=frontier,
        collect_stats=with_stats, fused_init=(vals0, absorbed),
        walk_index=walk_index)
    n_sweeps = 1 + loop_sweeps          # the fused pass is sweep #1
    n_traversals = n_sweeps

    if star:
        labels_sorted = torch.where(core, core_labels, -1)
    else:
        with obs_trace.span("border", engine=engine) as sp:
            labels_sorted = _assign_borders(tree, segs, eps, core,
                                            core_labels,
                                            walk_index=walk_index)
            sp.watch(labels_sorted)
        n_traversals += 1

    with obs_trace.span("finalize") as sp:
        labels, n_clusters = _finalize(labels_sorted, segs.order, n)
        core_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        core_mask[segs.order.long()] = core
        sp.watch(labels, core_mask)
    res = DBSCANResult(labels=labels, core_mask=core_mask,
                       n_clusters=n_clusters, n_sweeps=n_sweeps,
                       n_traversals=n_traversals, backend=backend)
    if with_stats:
        stats = dict(sweep_stats)
        stats["first_pass_iters"] = int(first.iters.sum())
        stats["first_pass_evals"] = int(first.evals.sum())
        return res, stats
    return res


def dbscan(points, eps: float, min_pts: int, *, algorithm: str = "auto",
           star: bool = False, frontier: bool = True,
           device=None) -> DBSCANResult:
    """DBSCAN via the paper's tree-based algorithms: the reference's
    module-level entry, here the dispatcher's (``dispatch.dbscan``), which
    builds (and caches) the named index and clusters it. star=True
    implements DBSCAN* (no border points; non-core -> noise).
    frontier=False forces full (unrestricted) sweeps."""
    from . import dispatch
    return dispatch.dbscan(points, eps, min_pts, algorithm=algorithm,
                           star=star, frontier=frontier, device=device)
