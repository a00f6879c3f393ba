"""Predicate/callback BVH traversal engine fused with visitor epilogues.

The engine the paper's framework (ArborX) exposes, over tensors:

    ``traverse(tree, segs, predicates, callback, carry) -> Trace``

where a **predicate batch** describes the queries and their geometry —
``intersects(sphere(eps))`` for fixed-radius search — and a **callback** is a
visitor consuming matched neighbors *on the fly* over an accumulator
(the ``carry``); neighbor lists are never materialized (the paper's
O(n)-memory claim).

The DBSCAN epilogues are visitor instances over this engine:

  * :class:`CountVisitor`         — |N_eps(q)| with early exit at ``cap``;
  * :class:`MinLabelVisitor`      — min gathered label over masked
                                    neighbors (hook sweeps, border gather);
  * :class:`CountMinLabelVisitor` — the fused first pass: count *and*
                                    min-label candidate in one walk.

This module is the *plain* engine: the walk written out over a lane vector
(one entry per query), every step a handful of tensor ops over all lanes.
It runs on any device and is the reference for the hand-written walk kernel
(``repro_torch.kernels.traverse``), which performs the same steps one thread
per lane:

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

    evals: member distance evaluations per lane — the paper's work metric.
    iters: loop trips per lane (after unrolling).
    """
    carry: AccHits
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
    r2)``: the lane id vector (-1 marks inert padding), the per-lane query
    coordinates, the engine context source arrays, whether the batch is
    external, and the squared search radius. Shared by the plain engine and
    the walk kernel's wrapper so both resolve predicates identically.
    """
    n = segs.n_points
    pts = segs.pts
    dev = pts.device
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
    return (query_ids, q_arr, self_arr, dense_arr, rank_arr, external, r2)


def _tree_left(tree: Tree, node):
    return tree.left[torch.clamp(node, 0, tree.left.shape[0] - 1)]


def make_step(tree: Tree, segs: Segments, callback, *, q, ctx: QueryCtx,
              lane_wide, r2: float, node_mask=None, node_mask_wide=None,
              use_range_mask: bool = False):
    """Build the dead-guarded one-unit-of-work step for the rope walk.

    ``step`` maps ``(node, ptr, carry, evals) -> (node, ptr, carry,
    evals)`` over lane vectors, every state update masked by the lane's
    liveness (the dead-guarding that makes unrolling exact); ``live_of(node,
    carry)`` is the lane's loop condition. The walk kernel
    (``csrc/walk.cu``) performs this same step per thread.
    """
    m = segs.n_segments
    leaf_off = m - 1
    pts = segs.pts
    dual_nodes = node_mask_wide is not None

    def live_of(node, carry):
        return (node >= 0) & ~callback.done(carry, ctx)

    def step(state):
        """One unit of work; a no-op for lanes that already finished."""
        node, ptr, carry, evals = state
        live = live_of(node, carry)
        node_safe = torch.clamp_min(node, 0)
        is_member = live & (ptr >= 0)

        # ---- member step: one distance test against sorted point ptr --
        j = torch.where(is_member, ptr, 0)
        diff = q - pts[j]
        d2 = sum_sq(diff)
        hit = is_member & (d2 <= r2)
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
        overlap = bd2 <= r2
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
        carry_new = AccHits(*(torch.where(is_member, cm, c)
                              for cm, c in zip(carry_m, carry)))
        evals_new = evals + is_member.to(torch.int32)
        # freeze finished lanes so unrolled sub-steps are no-ops
        return (torch.where(live, node_new, node),
                torch.where(live, ptr_new, ptr),
                AccHits(*(torch.where(live, cn, c)
                          for cn, c in zip(carry_new, carry))),
                torch.where(live, evals_new, evals))

    return step, live_of


def traverse(tree: Tree, segs: Segments, predicates, callback, carry=None,
             node_mask=None, node_mask_wide=None, wide_lanes=None,
             use_range_mask: bool = False,
             unroll: int = DEFAULT_UNROLL) -> Trace:
    """Run one fused traversal per predicate lane, driving ``callback``.

    The plain engine: it runs on whatever device the index lives on.
    ``repro_torch.kernels.traverse.traverse`` is the entry the clustering
    phases call; it routes CPU tensors here and CUDA tensors to the walk
    kernel.

    predicates: an :func:`intersects` batch. Its ``ids``/``pts`` select
        resident vs external queries and mark inert (-1) padding lanes.
    callback: a :class:`Visitor`; its hooks consume matches on the fly.
    carry: initial :class:`AccHits` (leading dim = lane count). ``None``
        asks the callback (``init_carry``); passing a previous walk's carry
        chains one query batch across several trees.
    node_mask: optional (2m-1,) bool per-node flag; subtrees whose flag is
        False are pruned as if their boxes missed (frontier sweeps).
    node_mask_wide / wide_lanes: optional second node mask selected per
        lane by the boolean ``wide_lanes``; lanes flagged wide also get
        ``ctx.wide`` so a dual-mask visitor switches its gather mask (the
        split first main sweep).
    unroll: work units per loop trip (``iters`` counts trips).
    """
    traverse.runs += 1
    (query_ids, q_arr, self_arr, dense_arr, rank_arr, external,
     r2) = lane_arrays(segs, predicates, use_range_mask)
    if carry is None:
        carry = callback.init_carry(query_ids, external, segs)
    if wide_lanes is None:
        wide_lanes = torch.zeros_like(query_ids, dtype=torch.bool)
    ctx = QueryCtx(self_id=self_arr, dense=dense_arr, rank=rank_arr,
                   wide=wide_lanes)
    step, live_of = make_step(tree, segs, callback, q=q_arr, ctx=ctx,
                              lane_wide=wide_lanes, r2=r2,
                              node_mask=node_mask,
                              node_mask_wide=node_mask_wide,
                              use_range_mask=use_range_mask)
    m = segs.n_segments
    root = 0 if m > 1 else m - 1          # m == 1: the single leaf
    node = torch.where(query_ids >= 0, root, -1).to(torch.int32)
    ptr = torch.full_like(node, -1)
    evals = torch.zeros_like(node)
    iters = torch.zeros_like(node)
    carry = AccHits(*carry)
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
