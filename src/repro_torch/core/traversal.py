"""Predicate/callback BVH traversal engine fused with visitor epilogues.

The engine the paper's framework (ArborX) exposes, over tensors:

    ``traverse(tree, segs, predicates, callback, carry) -> Trace``

where a **predicate batch** describes the queries and their geometry —
``intersects(sphere(eps))`` for fixed-radius search, ``nearest(k)`` for
distance-bounded k-nearest-neighbor search — and a **callback** is a
visitor consuming matched neighbors *on the fly* over an accumulator
(the ``carry``: a tensor, or a tuple or NamedTuple of tensors, each with
the lane count as its leading dim); neighbor lists are never materialized
(the paper's O(n)-memory claim).

The DBSCAN epilogues are visitor instances over this engine:

  * :class:`CountVisitor`         — |N_eps(q)| with early exit at ``cap``;
  * :class:`MinLabelVisitor`      — min gathered label over masked
                                    neighbors (hook sweeps, border gather);
  * :class:`CountMinLabelVisitor` — the fused first pass: count *and*
                                    min-label candidate in one walk;
  * :class:`KNNVisitor`           — the k-best (d2, id) list behind
                                    ``repro_torch.neighbors.knn``.

This module is the *plain* engine: the walk written out over a lane vector
(one entry per query), every step a handful of tensor ops over all lanes.
It runs on any device and is the reference for the hand-written walk kernel
(``repro_torch.kernels.traverse``) and for the k-NN walk kernel
(``repro_torch.kernels.knn``), which perform the same steps one thread per
lane:

  * per-query traversal stack  ->  precomputed ropes (``Tree.miss``), O(1)
    state per lane;
  * early exit  ->  the callback's ``done(carry)`` hook feeds the lane's
    liveness;
  * the paper's "hide leaves j < i" mask  ->  a range test on
    ``Tree.range_r`` via ``use_range_mask``;
  * each loop trip runs ``unroll`` work units (box tests or member
    distances), every state update masked by the lane's liveness, so lanes
    freeze exactly where the one-unit walk would;
  * queries are addressed by the predicate batch's explicit ``ids`` vector,
    so frontier sweeps traverse a *compacted* active subset.

External queries: ``intersects(sphere(eps), pts=...)`` decouples the query
set from the tree's primitives — a lane traverses for an arbitrary point.
External lanes have no resident identity, so self-exclusion and the
dense/query-rank shortcuts are disabled.

Float discipline: every squared distance is ``x0*x0`` followed by one fused
multiply-add per further axis (``lbvh.sum_sq``), which is how the
reference's compiled walk rounds ``sum(diff * diff)``; the search radius is
squared in float32 after rounding ``eps`` to float32.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .grid import Segments
from .lbvh import Tree, box_dist2, sum_sq

INT_MAX = 2**31 - 1

# Work units per loop trip of the plain engine. Each trip costs a host
# sync (the any-lane-live test), and the masked sub-steps are pure
# overhead for a vectorized loop, so the plain engine takes one unit per
# trip; the walk kernel has its own default.
DEFAULT_UNROLL = 1


# --------------------------------------------------------------------- #
# predicates                                                            #
# --------------------------------------------------------------------- #

class Sphere(NamedTuple):
    """Search geometry: a ball of radius ``r`` around each query point."""
    r: Any


def sphere(r) -> Sphere:
    """The eps-ball geometry for :func:`intersects` predicates."""
    return Sphere(r)


class Intersects(NamedTuple):
    """A batch of fixed-radius queries (ArborX's ``intersects(sphere)``).

    geometry: the shared :class:`Sphere`.
    ids: int32 sorted-order point indices; ``-1`` marks an inert (padding)
        lane. ``None`` traverses every resident point.
    pts: optional (k, d) float32 *external* query coordinates. When given,
        lane i traverses for ``pts[i]`` instead of a tree point and ``ids``
        only carries the inert-lane marker (-1 inert, anything else active).
    """
    geometry: Sphere
    ids: Any = None
    pts: Any = None


def intersects(geometry, ids=None, pts=None) -> Intersects:
    """Fixed-radius predicate batch: ``intersects(sphere(eps))``."""
    if not isinstance(geometry, Sphere):
        geometry = Sphere(geometry)
    return Intersects(geometry, ids, pts)


class Nearest(NamedTuple):
    """A batch of k-nearest-neighbor queries (ArborX's ``nearest(k)``).

    The walk is *distance-bounded*: a lane's box tests and member tests
    prune against ``min(r^2, worst-so-far)``, where worst-so-far is the
    callback's current k-th best squared distance (its ``worst_d2`` hook),
    so the search ball shrinks as better neighbors are found. ``r``
    optionally caps the search radius (``None``: unbounded); ``ids`` and
    ``pts`` work as in :class:`Intersects`.
    """
    k: int
    r: Any = None
    ids: Any = None
    pts: Any = None


def nearest(k: int, r=None, ids=None, pts=None) -> Nearest:
    """k-NN predicate batch: ``nearest(k)``, optionally radius-capped."""
    return Nearest(int(k), r, ids, pts)


# --------------------------------------------------------------------- #
# callback protocol                                                     #
# --------------------------------------------------------------------- #

class QueryCtx(NamedTuple):
    """Per-lane engine context handed to every callback hook.

    self_id: the lane's own sorted point index (-1 for external lanes).
    dense:   the query point lives in a dense segment.
    rank:    the query's segment rank (``use_range_mask`` support).
    wide:    this lane uses the callback's *wide* gather mask (the split
             first sweep).
    """
    self_id: torch.Tensor
    dense: torch.Tensor
    rank: torch.Tensor
    wide: torch.Tensor


class AccHits(NamedTuple):
    """The standard DBSCAN carry: an accumulator + a match counter.

    acc:  saturated neighbor count (incl. self) for :class:`CountVisitor`;
          min gathered value for the min-label visitors.
    hits: matched neighbors *excluding* the query itself.
    """
    acc: torch.Tensor
    hits: torch.Tensor


class Trace(NamedTuple):
    """Traversal outputs: the final callback carry + work counters.

    carry: the callback's accumulator, one entry per lane.
    evals: member distance evaluations per lane — the paper's work metric.
    iters: loop trips per lane (after unrolling).

    ``acc``/``hits`` forward into an :class:`AccHits` carry.
    """
    carry: Any
    evals: torch.Tensor
    iters: torch.Tensor

    @property
    def acc(self):
        return self.carry.acc

    @property
    def hits(self):
        return self.carry.hits


class Visitor:
    """Base callback over lane vectors.

    Hooks (called with per-lane tensors; misses and dead lanes must be
    masked, never branched on, which keeps the unrolled dead-guarding
    exact):

      init_carry(ids, external, segs) -> carry
      visit(carry, j, d2, hit, ctx) -> (carry, matched)
      done(carry, ctx) -> bool per lane (lane early exit)
      segment_done(carry, matched, seg_dense, ctx) -> bool per lane
          (the dense-cell short-circuit: all members of a dense segment
          share one label and core status, so one accepted hit can stand
          for the whole cell — paper §4.2)
    """

    def init_carry(self, ids, external: bool, segs: Segments):
        raise NotImplementedError

    def visit(self, carry, j, d2, hit, ctx):
        raise NotImplementedError

    def done(self, carry, ctx):
        return torch.zeros_like(ctx.self_id, dtype=torch.bool)

    def segment_done(self, carry, matched, seg_dense, ctx):
        return torch.zeros_like(matched)


class CountVisitor(Visitor):
    """acc = |N_eps(q)| (incl. self) saturated at ``cap``; the lane dies
    once ``acc`` reaches ``cap`` (the paper's min_pts early exit). hits
    counts matches excluding the query itself."""

    def __init__(self, cap: int = INT_MAX):
        self.cap = int(cap)

    def init_carry(self, ids, external, segs):
        z = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
        return AccHits(acc=z, hits=z)

    def visit(self, carry, j, d2, hit, ctx):
        acc = torch.clamp_max(carry.acc + hit.to(torch.int32), self.cap)
        hits = carry.hits + (hit & (j != ctx.self_id)).to(torch.int32)
        return AccHits(acc=acc, hits=hits), hit

    def done(self, carry, ctx):
        return carry.acc >= self.cap


class MinLabelVisitor(Visitor):
    """acc = min(vals[j]) over neighbors j with mask[j] (init: the query's
    own value); entering a *dense* segment stops at the first accepted
    member (all members share one label). ``mask_wide`` + the engine's
    ``wide_lanes`` run the split first sweep's narrow/wide gather choice
    per lane."""

    def __init__(self, vals, mask, mask_wide=None):
        self.vals = vals
        self.mask = mask
        self.mask_wide = mask_wide

    def init_carry(self, ids, external, segs):
        hits = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
        if external:
            return AccHits(acc=torch.full(ids.shape, INT_MAX,
                                          dtype=torch.int32,
                                          device=ids.device), hits=hits)
        return AccHits(acc=self.vals[torch.clamp_min(ids, 0)], hits=hits)

    def _accept(self, j, hit, ctx):
        if self.mask_wide is not None:
            return hit & torch.where(ctx.wide, self.mask_wide[j],
                                     self.mask[j])
        return hit & self.mask[j]

    def visit(self, carry, j, d2, hit, ctx):
        ok = self._accept(j, hit, ctx)
        acc = torch.where(ok, torch.minimum(carry.acc, self.vals[j]),
                          carry.acc)
        hits = carry.hits + (ok & (j != ctx.self_id)).to(torch.int32)
        return AccHits(acc=acc, hits=hits), ok

    def segment_done(self, carry, matched, seg_dense, ctx):
        return matched & seg_dense


class CountMinLabelVisitor(MinLabelVisitor):
    """The fused first pass — acc as in :class:`MinLabelVisitor` *and*
    hits = neighbor count saturated at ``cap`` in the same walk. The lane
    never exits early (the gather needs the full neighborhood), but the
    dense short-circuit fires for dense queries and for lanes whose count
    has saturated."""

    def __init__(self, vals, mask, cap: int = INT_MAX):
        super().__init__(vals, mask)
        self.cap = int(cap)

    def visit(self, carry, j, d2, hit, ctx):
        ok = hit & self.mask[j]
        acc = torch.where(ok, torch.minimum(carry.acc, self.vals[j]),
                          carry.acc)
        hits = torch.clamp_max(
            carry.hits + (ok & (j != ctx.self_id)).to(torch.int32), self.cap)
        return AccHits(acc=acc, hits=hits), ok

    def segment_done(self, carry, matched, seg_dense, ctx):
        return matched & seg_dense & (ctx.dense | (carry.hits >= self.cap))


class KNNCarry(NamedTuple):
    """Per-lane k-best lists, each ascending by (d2, id); empty slots are
    (+inf, -1)."""
    d2: torch.Tensor    # (L, k) float32
    ids: torch.Tensor   # (L, k) int32


class KNNVisitor(Visitor):
    """Keeps the k nearest neighbors per lane under a shrinking distance
    bound (pairs with the :class:`Nearest` predicate).

    Selection is lexicographic on (d2, id), exactly a stable argsort of the
    brute-force distance row: ties at the k-th distance go to the smaller
    id, and tie *sets* match brute force. ``id_map`` remaps the engine's
    sorted point index before the comparison and in the carry (pass
    ``segs.order`` to select and record by original index); ``None`` keeps
    sorted-space ids. ``worst_d2`` feeds the engine's per-lane bound. The
    query point itself is a neighbor at d2 = 0."""

    def __init__(self, k: int, id_map=None):
        self.k = int(k)
        self.id_map = id_map

    def init_carry(self, ids, external, segs):
        shape = (ids.shape[0], self.k)
        return KNNCarry(
            d2=torch.full(shape, float("inf"), dtype=segs.pts.dtype,
                          device=ids.device),
            ids=torch.full(shape, -1, dtype=torch.int32, device=ids.device))

    def worst_d2(self, carry):
        return carry.d2[:, self.k - 1]

    def visit(self, carry, j, d2, hit, ctx):
        dd, ii = carry.d2, carry.ids
        jid = j if self.id_map is None else self.id_map[j].to(torch.int32)
        # slots strictly better than the candidate under (d2, id) order
        c2, cid = d2[:, None], jid[:, None]
        better = (dd < c2) | ((dd == c2) & (ii < cid))
        pos = better.sum(1, dtype=torch.int32)[:, None]
        ar = torch.arange(self.k, dtype=torch.int32, device=dd.device)
        d_sh, i_sh = torch.roll(dd, 1, 1), torch.roll(ii, 1, 1)
        nd = torch.where(ar < pos, dd, torch.where(ar == pos, c2, d_sh))
        ni = torch.where(ar < pos, ii, torch.where(ar == pos, cid, i_sh))
        take = hit & (pos[:, 0] < self.k)
        return KNNCarry(d2=torch.where(take[:, None], nd, dd),
                        ids=torch.where(take[:, None], ni, ii)), take


# --------------------------------------------------------------------- #
# carries: a tensor or a (named) tuple of tensors                       #
# --------------------------------------------------------------------- #

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a carry (a tensor, or a tuple, list or
    NamedTuple of carries, whose type is kept), with ``rest`` carries of
    the same structure passed beside each leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    raise TypeError(f"a carry is a tensor or a (named) tuple of carries; "
                    f"got {type(tree).__name__}")


def lane_where(mask, a, b):
    """``torch.where`` of two carries on a per-lane mask, broadcast over
    each leaf's trailing dims."""
    return tree_map(
        lambda x, y: torch.where(
            mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y), a, b)


# --------------------------------------------------------------------- #
# the engine                                                            #
# --------------------------------------------------------------------- #

def radius2(r) -> float:
    """The squared search radius: ``r`` rounded to float32, squared in
    float32 (returned as a Python float holding that float32 value)."""
    r32 = np.float32(r)
    return float(r32 * r32)


def lane_arrays(segs: Segments, predicates, use_range_mask: bool = False):
    """Resolve a predicate batch into per-lane query arrays.

    Returns ``(query_ids, q_arr, self_arr, dense_arr, rank_arr, external,
    r2, is_nearest)``: the lane id vector (-1 marks inert padding), the
    per-lane query coordinates, the engine context source arrays, whether
    the batch is external, the squared (initial) search radius (``inf``
    for an uncapped :class:`Nearest` batch), and whether the batch is
    distance-bounded k-NN. Shared by the plain engine and the kernels'
    wrappers so all resolve predicates identically.
    """
    n = segs.n_points
    pts = segs.pts
    dev = pts.device
    is_nearest = isinstance(predicates, Nearest)
    if is_nearest:
        r2 = float("inf") if predicates.r is None else radius2(predicates.r)
    else:
        r2 = radius2(predicates.geometry.r)
    query_ids, query_pts = predicates.ids, predicates.pts
    external = query_pts is not None
    if external:
        if use_range_mask:
            raise ValueError("use_range_mask needs tree-resident queries")
        if query_ids is None:
            query_ids = torch.zeros(query_pts.shape[0], dtype=torch.int32,
                                    device=dev)
        q_arr = query_pts
        self_arr = torch.full(query_ids.shape, -1, dtype=torch.int32,
                              device=dev)   # never matches
        dense_arr = torch.zeros(query_ids.shape, dtype=torch.bool, device=dev)
        rank_arr = torch.zeros(query_ids.shape, dtype=torch.int32, device=dev)
    else:
        if query_ids is None:
            query_ids = torch.arange(n, dtype=torch.int32, device=dev)
        safe = torch.clamp_min(query_ids, 0)
        q_arr = pts[safe]
        self_arr = query_ids
        dense_arr = segs.dense_pt[safe]
        rank_arr = segs.seg_of_point[safe]
    return (query_ids, q_arr, self_arr, dense_arr, rank_arr, external, r2,
            is_nearest)


def _tree_left(tree: Tree, node):
    return tree.left[torch.clamp(node, 0, tree.left.shape[0] - 1)]


def make_step(tree: Tree, segs: Segments, callback, *, q, ctx: QueryCtx,
              lane_wide, r2: float, is_nearest: bool = False,
              node_mask=None, node_mask_wide=None,
              use_range_mask: bool = False):
    """Build the dead-guarded one-unit-of-work step for the rope walk.

    ``step`` maps ``(node, ptr, carry, evals) -> (node, ptr, carry,
    evals)`` over lane vectors, every state update masked by the lane's
    liveness (the dead-guarding that makes unrolling exact); ``live_of(node,
    carry)`` is the lane's loop condition. The walk kernels
    (``csrc/walk.cu``, ``csrc/knn.cu``) perform this same step per thread.
    """
    m = segs.n_segments
    leaf_off = m - 1
    pts = segs.pts
    dual_nodes = node_mask_wide is not None

    def bound2(carry):
        """Per-lane squared search radius at this instant."""
        if is_nearest:
            return torch.clamp_max(callback.worst_d2(carry), r2)
        return r2

    def live_of(node, carry):
        return (node >= 0) & ~callback.done(carry, ctx)

    def step(state):
        """One unit of work; a no-op for lanes that already finished."""
        node, ptr, carry, evals = state
        live = live_of(node, carry)
        node_safe = torch.clamp_min(node, 0)
        is_member = live & (ptr >= 0)
        bnd = bound2(carry)

        # ---- member step: one distance test against sorted point ptr --
        j = torch.where(is_member, ptr, 0)
        diff = q - pts[j]
        d2 = sum_sq(diff)
        hit = is_member & (d2 <= bnd)
        seg_id = torch.where(node_safe >= leaf_off, node_safe - leaf_off, 0)
        carry_m, matched = callback.visit(carry, j, d2, hit, ctx)
        stop_seg = callback.segment_done(carry_m, matched,
                                         segs.dense_seg[seg_id], ctx)
        seg_done = (ptr + 1 >= segs.seg_end[seg_id]) | stop_seg
        member_next_node = torch.where(seg_done, tree.miss[node_safe], node)
        member_next_ptr = torch.where(seg_done, -1, ptr + 1)

        # ---- node step: descend / skip -------------------------------
        is_leaf = node_safe >= leaf_off
        seg = torch.where(is_leaf, node_safe - leaf_off, 0)
        bd2 = box_dist2(q, tree.box_lo[node_safe], tree.box_hi[node_safe])
        overlap = bd2 <= bnd
        if use_range_mask:
            overlap = overlap & (tree.range_r[node_safe] >= ctx.rank)
        if node_mask is not None:
            if dual_nodes:
                overlap = overlap & torch.where(lane_wide,
                                                node_mask_wide[node_safe],
                                                node_mask[node_safe])
            else:
                overlap = overlap & node_mask[node_safe]
        # internal: go left on overlap else rope; leaf: enter members on
        # overlap (empty segments skip straight to the rope).
        child = torch.where(node_safe < leaf_off,
                            torch.where(overlap, _tree_left(tree, node_safe),
                                        tree.miss[node_safe]),
                            node)
        enter_members = is_leaf & overlap & (segs.seg_start[seg]
                                             < segs.seg_end[seg])
        node_next_node = torch.where(is_leaf,
                                     torch.where(enter_members, node,
                                                 tree.miss[node_safe]),
                                     child)
        node_next_ptr = torch.where(enter_members, segs.seg_start[seg], -1)

        node_new = torch.where(is_member, member_next_node, node_next_node)
        ptr_new = torch.where(is_member, member_next_ptr, node_next_ptr)
        carry_new = lane_where(is_member, carry_m, carry)
        evals_new = evals + is_member.to(torch.int32)
        # freeze finished lanes so unrolled sub-steps are no-ops
        return (torch.where(live, node_new, node),
                torch.where(live, ptr_new, ptr),
                lane_where(live, carry_new, carry),
                torch.where(live, evals_new, evals))

    return step, live_of


def traverse(tree: Tree, segs: Segments, predicates, callback, carry=None,
             node_mask=None, node_mask_wide=None, wide_lanes=None,
             use_range_mask: bool = False,
             unroll: int = DEFAULT_UNROLL, root=None) -> Trace:
    """Run one fused traversal per predicate lane, driving ``callback``.

    The plain engine: it runs on whatever device the index lives on.
    ``repro_torch.kernels.traverse.traverse`` is the entry the clustering
    phases call; it routes CPU tensors here and CUDA tensors to the walk
    kernel.

    predicates: an :func:`intersects` or :func:`nearest` batch. Its
        ``ids``/``pts`` select resident vs external queries and mark inert
        (-1) padding lanes.
    callback: a :class:`Visitor`; its hooks consume matches on the fly.
        With a :func:`nearest` batch it must have ``worst_d2(carry)``.
    carry: the initial accumulator: a tensor or a (named) tuple of tensors,
        each with the lane count as its leading dim (masks broadcast over
        trailing dims). ``None`` asks the callback (``init_carry``);
        passing a previous walk's carry chains one query batch across
        several trees.
    node_mask: optional (2m-1,) bool per-node flag; subtrees whose flag is
        False are pruned as if their boxes missed (frontier sweeps).
    node_mask_wide / wide_lanes: optional second node mask selected per
        lane by the boolean ``wide_lanes``; lanes flagged wide also get
        ``ctx.wide`` so a dual-mask visitor switches its gather mask (the
        split first main sweep).
    unroll: work units per loop trip (``iters`` counts trips).
    root: optional (lanes,) int32 node each lane starts from (default the
        root, node 0). A forest of trees packed into one index (the
        sharded path's shards, ``repro_torch.distributed``) gives each
        lane its own tree's root; a tree's rope out of its root is -1, so
        the lane's walk ends where that tree does.
    """
    traverse.runs += 1
    (query_ids, q_arr, self_arr, dense_arr, rank_arr, external, r2,
     is_nearest) = lane_arrays(segs, predicates, use_range_mask)
    if carry is None:
        carry = callback.init_carry(query_ids, external, segs)
    if wide_lanes is None:
        wide_lanes = torch.zeros_like(query_ids, dtype=torch.bool)
    ctx = QueryCtx(self_id=self_arr, dense=dense_arr, rank=rank_arr,
                   wide=wide_lanes)
    step, live_of = make_step(tree, segs, callback, q=q_arr, ctx=ctx,
                              lane_wide=wide_lanes, r2=r2,
                              is_nearest=is_nearest,
                              node_mask=node_mask,
                              node_mask_wide=node_mask_wide,
                              use_range_mask=use_range_mask)
    m = segs.n_segments
    if root is None:
        root = 0 if m > 1 else m - 1      # m == 1: the single leaf
    node = torch.where(query_ids >= 0, root, -1).to(torch.int32)
    ptr = torch.full_like(node, -1)
    evals = torch.zeros_like(node)
    iters = torch.zeros_like(node)
    while True:
        trip_live = live_of(node, carry)
        if not bool(trip_live.any()):
            break
        state = (node, ptr, carry, evals)
        for _ in range(unroll):
            state = step(state)
        node, ptr, carry, evals = state
        iters = iters + trip_live.to(torch.int32)
    return Trace(carry=carry, evals=evals, iters=iters)


# Plain-engine runs (a plain integer, read by the on-card smoke run to
# show that no walk of the main path took this route).
traverse.runs = 0


def tree_left(tree: Tree, node):
    """The left child of internal node ``node`` (clamped into range)."""
    return _tree_left(tree, node)


def lane_sort_key(reorder: str, query_ids, q_arr, external: bool,
                  depth_rank=None):
    """Per-lane sort key for lane reordering (the reference's
    ``lane_sort_key``; int64 keys holding the reference's values).

    A walk may permute its lanes by this key before it runs and apply the
    inverse permutation to every per-lane output after, so no output
    changes (``repro_torch.kernels.traverse.traverse(reorder=...)``).
    Policies:

      * ``"none"``   — no key (identity).
      * ``"morton"`` — the query points' Morton codes (the uint32 value),
        so neighbouring lanes walk neighbouring subtrees; the only option
        for external batches.
      * ``"depth"``  — ``-depth_rank[query_id]``, where ``depth_rank`` is
        the per-query loop-trip count of a prior pass over the same index
        (``Trace.iters`` of the fused first pass, by sorted point id), so
        the deepest walks go first. Falls back to Morton for external
        batches and to ``None`` when no rank is given.

    Dead lanes (``query_ids < 0``) get the largest key of their policy
    (``0xFFFFFFFF`` for Morton keys, ``INT_MAX`` for depth keys). Returns
    the key tensor, or ``None`` when the order is the identity. Raises
    ``ValueError`` for any other policy.
    """
    if reorder in (None, "none"):
        return None
    if reorder not in ("morton", "depth"):
        raise ValueError(
            f"reorder must be 'none', 'morton' or 'depth'; got {reorder!r}")
    live = query_ids >= 0
    if reorder == "depth" and not external:
        if depth_rank is None:
            return None
        depth = depth_rank[torch.clamp_min(query_ids, 0).long()].long()
        return torch.where(live, -depth, INT_MAX)
    from .morton import morton_encode
    if q_arr.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=q_arr.device)
    return torch.where(live, morton_encode(q_arr), 0xFFFFFFFF)


def _ids_from_mask(n: int, query_active, device) -> torch.Tensor:
    """Full-width id vector with inactive lanes marked -1 (no compaction)."""
    ids = torch.arange(n, dtype=torch.int32, device=device)
    if query_active is None:
        return ids
    return torch.where(query_active, ids, -1)


def _walk_fn(tree: Tree, segs: Segments, walk_index):
    """The walk kernel's entry (plain engine for CPU tensors) with the
    index's packed layout bound: ``walk_index`` if given, else packed here
    once for a CUDA index."""
    from repro_torch.kernels import traverse as kt
    if walk_index is None and segs.pts.device.type == "cuda" \
            and tree is not None:
        from repro_torch.kernels.walkpack import pack_index
        walk_index = pack_index(tree, segs)

    def walk(*args, **kw):
        return kt.traverse(*args, walk_index=walk_index, **kw)
    return walk


# --------------------------------------------------------------------- #
# DBSCAN epilogue helpers (visitor instances over the walk)             #
# --------------------------------------------------------------------- #
# On CPU tensors these run the plain engine; on CUDA tensors the walk
# kernel (never the plain engine), with the index's packed layout taken
# from ``walk_index`` or packed once per call.

def count_neighbors(tree: Tree, segs: Segments, eps: float, cap: int,
                    query_active=None, *, walk_index=None) -> torch.Tensor:
    """|N_eps(x)| per sorted point, saturated at ``cap`` (early exit)."""
    return count_neighbors_with_work(tree, segs, eps, cap, query_active,
                                     walk_index=walk_index)[0]


def count_neighbors_with_work(tree: Tree, segs: Segments, eps: float,
                              cap: int, query_active=None, *,
                              walk_index=None):
    """(counts, distance_evaluations) — the paper's work metric."""
    n = segs.n_points
    tr = _walk_fn(tree, segs, walk_index)(
        tree, segs,
        intersects(sphere(eps),
                   ids=_ids_from_mask(n, query_active, segs.pts.device)),
        CountVisitor(cap=cap))
    return tr.acc, tr.evals


def minlabel_sweep(tree: Tree, segs: Segments, eps: float, labels,
                   gather_mask, query_active, *, walk_index=None):
    """Per active query: min(label) over neighbors with gather_mask.

    Returns (min_labels, matched_other_count); an inactive query returns
    its own ``labels`` value (no-op hook). ``labels`` must already be
    consistent within dense segments (the caller re-unifies after updates).
    """
    tr = _walk_fn(tree, segs, walk_index)(
        tree, segs,
        intersects(sphere(eps), ids=_ids_from_mask(
            segs.n_points, query_active, segs.pts.device)),
        MinLabelVisitor(labels, gather_mask))
    # inactive lanes carry no query identity inside the walk; restore the
    # own-value contract here where lane i <=> point i
    return torch.where(query_active, tr.acc, labels), tr.hits


def fused_count_minlabel(tree: Tree, segs: Segments, eps: float,
                         point_vals, point_mask=None, query_ids=None,
                         cap: int = INT_MAX, traverse_fn=None,
                         depth_rank=None, *, walk_index=None) -> Trace:
    """The fused first pass: one walk, two answers.

    Returns the full ``Trace``: ``acc`` is the min gathered value over all
    masked neighbors (candidate label — the caller validates it against the
    core mask once counts are known), ``hits`` the neighbor count excluding
    self, exact up to saturation at ``cap`` (pass ``min_pts - 1``; dense
    queries are core by construction and may undercount). ``traverse_fn``
    swaps the walk (default: the walk kernel's entry, which runs the plain
    engine for CPU tensors, over ``walk_index``); ``depth_rank`` is the
    lane-order oracle of ``reorder="depth"``, forwarded only when given.
    """
    if point_mask is None:
        point_mask = torch.ones(segs.n_points, dtype=torch.bool,
                                device=segs.pts.device)
    if traverse_fn is None:
        traverse_fn = _walk_fn(tree, segs, walk_index)
    kw = {} if depth_rank is None else {"depth_rank": depth_rank}
    return traverse_fn(tree, segs, intersects(sphere(eps), ids=query_ids),
                       CountMinLabelVisitor(point_vals, point_mask, cap=cap),
                       **kw)


def border_gather(tree: Tree, segs: Segments, eps: float, root_labels,
                  core_mask, query_active, *, walk_index=None):
    """Min core-neighbor root label per non-core query; INT_MAX if none."""
    vals = torch.where(core_mask, root_labels, INT_MAX)
    tr = _walk_fn(tree, segs, walk_index)(
        tree, segs,
        intersects(sphere(eps), ids=_ids_from_mask(
            segs.n_points, query_active, segs.pts.device)),
        MinLabelVisitor(vals, core_mask))
    # active lanes start from vals[q] (INT_MAX for non-core queries), so
    # acc == INT_MAX <=> no core neighbor (noise); inactive lanes return
    # their own vals[q] to keep the lane i <=> point i contract.
    return torch.where(query_active, tr.acc, vals), tr.hits
