"""Streaming DBSCAN over a tiered LSM index of LBVHs (DESIGN.md §7, §11).

``StreamingDBSCAN`` keeps density clusters live under online insertions
*and deletions* — the serving path the batch pipeline cannot cover (it
reclusters from scratch per call). Five operations:

  * ``query(pts)``    — read-only cluster assignment for a batch of probe
                        points (external-query walks, no mutation);
  * ``insert(pts)``   — micro-batch ingestion with bidirectional core-count
                        updates and incremental label repair;
  * ``delete(ids)``   — tombstone resident points by global insert id, with
                        exact core-count recomputation and demotion repair;
  * ``expire(w)``     — tombstone every point with insert id below the
                        watermark ``w`` (the sliding-window primitive —
                        ``window=`` automates it per insert);
  * ``snapshot()``    — materialized labels over the *surviving* points,
                        component-identical to batch ``dbscan`` on exactly
                        the active set.

LSM-style tiered index: one large *main* LBVH (tier 0, built at
construction or at the last full merge), a stack of sealed delta tiers of
geometrically growing sizes, and a small insert *buffer* rebuilt per
batch. Every operation walks all levels with external predicate batches
(``traversal.intersects(sphere(eps), pts=...)``), chaining the running
accumulator through the visitor carry from level to level. When the
buffer outgrows ``buffer_max`` live points it is sealed into a tier;
adjacent tiers of the same size class (``growth``-fold geometric classes)
merge in a cascade; and when the whole delta outgrows ``merge_ratio``
times the main, a full merge re-sorts the active union along the Morton
curve into a single tier. Compactions and merges drop tombstoned rows and
touch only the index — labels, counts, and the core mask live in flat
gid-indexed tensors, so they are label-invariant on survivors by
construction.

Deletion is tombstoning + *exact recount* + *demotion repair*:

  * counts saturate at ``min_pts`` — sound for increments but not for
    decrements (``min(c, mp) - dec`` loses the overshoot), so the points
    eps-near a deleted row get their counts *recomputed* against the
    alive-masked levels rather than decremented;
  * removing a point or demoting a core can *split* a component, and
    min-label propagation can only shrink labels — a split needs labels
    to grow. So the repair resets every surviving core of every affected
    component (old label in the set of reps touched by a dead or demoted
    core) to its own gid and re-runs exact frontier sweeps from that
    reset set. Cores outside affected components are untouched: two
    cores within eps are density-connected, so no eps-edge crosses
    between an affected and an unaffected component.

Labels always satisfy ``labels[i] <= i`` with component-minimum reps at
rest (tombstoned and non-core rows hold their own gid), so bulk pointer
jumping can never cycle.

This is the port of ``repro.stream.index``, exact to it: the same levels
(padded with the same sentinels to the same sizes), the same counts, core
mask, labels, tombstones and counters after every operation. The state —
the flat gid-indexed tensors and every level's ``Segments``, ``Tree`` and
packed ``WalkIndex`` — lives on the handle's device (default the current
CUDA device). There every level walk is a launch of the walk kernel
(``repro_torch.kernels.traverse``), with the level's layout packed once
when the level is built; on the CPU it is the plain engine. Query results,
``points``, ``active_gids`` and ``stream_slice`` are host (numpy) arrays,
as the reference's are; ``snapshot()`` returns the port's ``DBSCANResult``
with tensors on the device.

Distance arithmetic is float32 end to end and rounds as the reference
rounds: the walks as its compiled walk (``x0*x0`` then one fused
multiply-add per axis), the brute paths as its eager numpy code (every
multiply and add rounded on its own, written out term by term), so
boundary decisions agree bit for bit and ``snapshot()`` reproduces the
batch core mask exactly.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import dispatch, fdbscan, grid, lbvh, morton, traversal
from repro_torch.core import unionfind
from repro_torch.core.fdbscan import DBSCANResult
from repro_torch.core.validate import check_points
from repro_torch.kernels.ref import tile_sum_sq
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.stream import durability

INT_MAX = traversal.INT_MAX

# Delta/main size ratio above which an insert triggers an automatic full
# merge, and the floor below which the delta never auto-merges (tiny
# deltas are cheap to walk; rebuilding the main tree for them is not).
MERGE_RATIO = 0.25
MERGE_MIN = 256

# Tiered-compaction defaults: the insert buffer seals into a tier at
# BUFFER_MAX live points, and tiers merge in a cascade whenever the newest
# tier reaches the size class of its elder (classes grow GROWTH-fold).
BUFFER_MAX = MERGE_MIN
GROWTH = 4

# A sealed tier whose live fraction drops to half is rewritten without its
# tombstoned rows (classic LSM space-amplification bound).
_TOMB_MAX_FRAC = 0.5

# Sentinel padding offset in units of eps beyond a level's own bounding
# box: >= 3*eps along every axis keeps any real query (which can lie
# anywhere) from ever *matching* a sentinel in masked modes and keeps the
# box tests cheap; unmasked count mode is never run against a padded level.
_SENTINEL_EPS = 3.0

# Walk signatures (mode, d, probe bucket, level size, cap) seen in this
# process, under the reference's bucketing (fdbscan._pad_size). The
# reference compiles one program per signature; the port compiles nothing
# per shape, but counts new signatures the same way, so
# ``stream_query_recompiles_total`` reads the same in both packages.
_seen_programs: set = set()


def _note_program(sig: tuple) -> None:
    if sig not in _seen_programs:
        _seen_programs.add(sig)
        obs_metrics.inc("stream_query_recompiles_total")


class _Level(NamedTuple):
    """One level of the tiered index (main tier, delta tier, or buffer)."""
    segs: grid.Segments      # singleton segments, Morton order (+ sentinels)
    tree: lbvh.Tree | None   # None only for <2 resident points
    gids: torch.Tensor       # (n_prims,) int64 global insert id per sorted
                             # primitive; -1 marks a padding sentinel
    walk_index: Any = None   # the walk kernel's packed layout (CUDA only)


class QueryResult(NamedTuple):
    """Read-only cluster assignment for a probe batch (host arrays).

    labels: component representative (global insert id of the component's
            minimum member) of the min adjacent core point, or -1 when no
            core point lies within eps (the probe would be noise).
    counts: eps-neighbors among *active* resident points, saturated at
            ``min_pts``.
    would_be_core: the probe would be a core point if inserted now
            (counts + itself >= min_pts).
    """
    labels: np.ndarray
    counts: np.ndarray
    would_be_core: np.ndarray


def _build_index(pts, lo, hi):
    """Morton sort + singleton-segment LBVH build over ``pts``.

    Serves the full merge, tier compactions, and the padded buffer rebuild
    alike (``lo``/``hi`` are the *valid* points' bounds, so sentinels clip
    to the top cell).
    """
    codes = morton.morton_encode(pts, lo=lo, hi=hi)
    order = torch.argsort(codes, stable=True)
    segs = grid.singleton_segments(pts[order], order.to(torch.int32),
                                   codes[order])
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    return segs, tree


def _dist2_eager(diff: torch.Tensor) -> torch.Tensor:
    """Squared distances rounded as the reference's eager numpy
    ``(diff * diff).sum(-1)`` in float32: every multiply and add on its
    own, in axis order, written out term by term (a ``.sum(-1)`` has no
    fixed order of reduction on the card)."""
    return tile_sum_sq(diff, fma=False)


def _hits_blocked(a: torch.Tensor, b: torch.Tensor, eps2: torch.Tensor,
                  block: int = 2048) -> torch.Tensor:
    """# rows of ``b`` within eps of each row of ``a`` (int64); float32
    arithmetic rounded as the reference's brute path. Blocks of ``block``
    rows bound the (block, len(b), d) difference tensor."""
    out = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for lo in range(0, a.shape[0], block):
        diff = a[lo:lo + block, None, :] - b[None, :, :]
        out[lo:lo + block] = (_dist2_eager(diff) <= eps2).sum(1)
    return out


class StreamingDBSCAN:
    """Online DBSCAN handle: insert/delete micro-batches, query, snapshot.

    points: optional initial point set (clustered with the batch pipeline);
        ``None`` starts empty (the serving loop's cold-start path).
    index: optional prebuilt plain-FDBSCAN ``(segs, tree, walk_index)``
        over ``points`` on the handle's device — the dispatcher passes its
        cached eps-independent index (and its packed layout) here, so
        streaming composes with eps/min_pts parameter sweeps.
    merge_ratio: delta/main size ratio that triggers an automatic full
        merge.
    window: optional sliding-window size — after every insert, points
        whose insert id falls below ``n_points - window`` are expired
        automatically (insert-order watermark semantics).
    buffer_max: live-point budget of the insert buffer before it is sealed
        into a delta tier (tiered compaction knob; default BUFFER_MAX).
    growth: geometric size-class factor of the tier cascade (default
        GROWTH).
    wal: optional write-ahead log path (or a prebuilt
        ``durability.WriteAheadLog``): every insert/delete/expire batch is
        durably appended *before* it is applied, so an acknowledged
        operation survives a crash (DESIGN.md §10). The file must be
        fresh — a WAL with leftover records means a previous process
        died; go through :meth:`restore` instead of silently shadowing
        its state. Without a ``checkpoint_path``, bootstrap points are
        logged as the log's first (gid-0) record, so WAL-only recovery
        covers them too.
    checkpoint_path: optional checkpoint file; written atomically by
        :meth:`checkpoint` (and once at construction when the handle
        bootstraps from initial points, so they are durable too).
    checkpoint_every: auto-checkpoint policy — write ``checkpoint_path``
        after every K full index merges (0 = manual checkpoints only).
    device: where the state lives and the walks run; default the current
        CUDA device (``RuntimeError`` without one — pass ``device="cpu"``
        for the plain versions on the host).
    """

    def __init__(self, points, eps: float, min_pts: int, *,
                 merge_ratio: float = MERGE_RATIO, index=None,
                 window: int | None = None,
                 buffer_max: int = BUFFER_MAX, growth: int = GROWTH,
                 wal=None, checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, device=None):
        if eps <= 0:
            raise ValueError(f"streaming index needs eps > 0; got {eps}")
        if min_pts < 1:
            raise ValueError(f"min_pts must be >= 1; got {min_pts}")
        if window is not None and int(window) < 1:
            raise ValueError(f"window must be >= 1 point; got {window}")
        if buffer_max < 1:
            raise ValueError(f"buffer_max must be >= 1; got {buffer_max}")
        if growth < 2:
            raise ValueError(f"growth must be >= 2; got {growth}")
        self.device = dispatch.resolve_device(device)
        dev = self.device
        self.eps = float(eps)
        self.min_pts = int(min_pts)
        # eps rounded to float32 and squared in float32, as the walk's
        self._eps2 = torch.tensor(traversal.radius2(eps),
                                  dtype=torch.float32, device=dev)
        self._merge_ratio = float(merge_ratio)
        self.window = int(window) if window is not None else None
        self._buffer_max = int(buffer_max)
        self._growth = int(growth)
        self._pts = torch.zeros((0, 2), dtype=torch.float32, device=dev)
        # |N_eps| incl. self, saturated at min_pts
        self._counts = torch.zeros(0, dtype=torch.int32, device=dev)
        self._core = torch.zeros(0, dtype=torch.bool, device=dev)
        # core: component-min gid; non-core/dead: own gid
        self._labels = torch.zeros(0, dtype=torch.int32, device=dev)
        self._tombstone = torch.zeros(0, dtype=torch.bool, device=dev)
        self._n_tomb = 0
        self._tiers: list[_Level] = []         # oldest (largest) first
        self._buffer: _Level | None = None
        self._buffer_gids = self._gids(0)
        self._expire_watermark = 0
        self.n_inserts = 0
        self.n_deletes = 0                     # delete/expire ops applied
        self.n_merges = 0
        self.n_compactions = 0                 # tier seals/cascades/rewrites
        self.n_repair_sweeps = 0
        self._ckpt_path = checkpoint_path
        self._ckpt_every = int(checkpoint_every)
        self._merges_since_ckpt = 0
        if checkpoint_every and not checkpoint_path:
            raise ValueError("checkpoint_every needs a checkpoint_path")
        self._wal = None
        if wal is not None:
            if not isinstance(wal, durability.WriteAheadLog):
                wal = durability.WriteAheadLog(str(wal), eps=self.eps,
                                               min_pts=self.min_pts)
            _, stale, _ = durability.scan_wal(wal.path)
            if stale:
                raise durability.WALError(
                    f"{wal.path}: WAL already holds {len(stale)} record(s) "
                    "from a previous run — recover them with "
                    "StreamingDBSCAN.restore(...) or remove the file "
                    "before starting a fresh handle")
            self._wal = wal
        if points is not None:
            if isinstance(points, torch.Tensor):
                points = points.detach().cpu().numpy()
            pts = np.array(points, np.float32)   # copy: never alias callers
            if pts.size:
                self._bootstrap(self._check_pts(pts, grow=True), index)
                if self._ckpt_path is not None:
                    # make the bootstrap set durable: the WAL only covers
                    # inserts, so without this a crash before the first
                    # checkpoint would lose the initial clustering
                    self.checkpoint()
                elif self._wal is not None:
                    # WAL-only durability: log the bootstrap set as the
                    # gid-0 record, otherwise recovery cold-starts empty,
                    # every later record sits past a gap, and acknowledged
                    # inserts would be unrecoverable
                    self._wal.append(self._pts.cpu().numpy(), 0)
                if self.window is not None:
                    self.expire(self.n_points - self.window)

    # ------------------------------------------------------------------ #
    # public surface                                                     #
    # ------------------------------------------------------------------ #

    @property
    def n_points(self) -> int:
        """Total points ever inserted (the insert-order watermark);
        includes tombstoned rows — see :attr:`n_active`."""
        return self._pts.shape[0]

    @property
    def n_active(self) -> int:
        """Surviving (non-tombstoned) points."""
        return self._pts.shape[0] - self._n_tomb

    @property
    def n_tombstoned(self) -> int:
        """Deleted/expired points still occupying gid slots."""
        return self._n_tomb

    @property
    def n_main(self) -> int:
        """Live points in the main (oldest, largest) tier."""
        return self._live(self._tiers[0]) if self._tiers else 0

    @property
    def n_delta(self) -> int:
        """Live points outside the main tier (delta tiers + buffer)."""
        return self.n_active - self.n_main

    @property
    def n_tiers(self) -> int:
        """Sealed index tiers (excluding the insert buffer)."""
        return len(self._tiers)

    @property
    def _main(self) -> _Level | None:
        return self._tiers[0] if self._tiers else None

    @property
    def points(self) -> np.ndarray:
        """The *active* point set in insertion order (a host copy)."""
        return self._pts[~self._tombstone].cpu().numpy()

    @property
    def active_gids(self) -> np.ndarray:
        """Global insert ids of the active points, ascending (int64)."""
        return self._alive_gids().cpu().numpy()

    def freeze_view(self):
        """Export the active state for an immutable serving snapshot.

        Returns a ``repro_torch.serve.snapshot.FrozenState``: the active
        points with their serving values (core rows carry their
        component-min label, non-core rows ``INT_MAX``; int64), plus the
        stream watermark, as Python ints. The tensors are copies on the
        handle's device (boolean-mask indexing never returns a view): the
        writer updates ``_labels``, ``_core`` and ``_tombstone`` in place,
        and a published snapshot must not change with them. Pure read;
        never touches the tiers.
        """
        from repro_torch.serve.snapshot import FrozenState
        alive = ~self._tombstone
        vals = torch.where(self._core, self._labels.to(torch.int64), INT_MAX)
        return FrozenState(pts=self._pts[alive], vals=vals[alive],
                           watermark=self.n_points,
                           n_tombstoned=int(self._n_tomb))

    def stream_slice(self, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of the raw insert stream (tombstoned rows
        included — the stream is the replication log, not the active
        set), as a host array. Used to top up a lagging replica after
        crash recovery."""
        lo, hi = int(lo), int(hi)
        if not 0 <= lo <= hi <= self.n_points:
            raise ValueError(f"stream slice [{lo}, {hi}) out of range "
                             f"[0, {self.n_points})")
        return self._pts[lo:hi].cpu().numpy().copy()

    def query(self, pts) -> QueryResult:
        """Cluster assignment for probe points; never mutates the index."""
        with obs_trace.span("stream.query"):
            res = self._query_impl(pts)
        obs_metrics.inc("stream_queries_total")
        return res

    def _query_impl(self, pts) -> QueryResult:
        qpts = self._check_pts(pts, grow=False)
        k = qpts.shape[0]
        if k == 0 or self.n_active == 0:
            return QueryResult(np.full(k, -1, np.int32),
                               np.zeros(k, np.int32),
                               np.ones(k, bool) if self.min_pts <= 1
                               else np.zeros(k, bool))
        vals = self._core_vals()
        acc = self._full(k, INT_MAX)
        for lvl in self._levels():
            acc, _ = self._run(lvl, qpts, vals, self._core, acc,
                               mode="minlabel")
        counts = torch.zeros(k, dtype=torch.int64, device=self.device)
        for lvl in self._levels():
            counts += self._count(lvl, qpts)
        counts = torch.clamp_max(counts, self.min_pts).to(torch.int32)
        return QueryResult(
            labels=torch.where(acc == INT_MAX, -1, acc).to(
                torch.int32).cpu().numpy(),
            counts=counts.cpu().numpy(),
            would_be_core=(counts + 1 >= self.min_pts).cpu().numpy())

    def insert(self, pts) -> "StreamingDBSCAN":
        """Ingest a micro-batch: counts update bidirectionally, labels are
        repaired incrementally, the buffer is rebuilt (padded to a
        bucketed size), and an oversized buffer or delta triggers
        compaction / a full merge. In window mode the insert then
        auto-expires everything below the new watermark.

        With a WAL attached the batch is durably appended (fsync) before
        any state changes, so by the time ``insert`` returns — the
        *acknowledgment* — the batch survives a crash at any barrier.
        Raises ValueError for empty batches and NaN/Inf coordinates
        (nothing is logged or applied for a rejected batch)."""
        with obs_trace.span("stream.insert"):
            res = self._insert_impl(pts)
        obs_metrics.inc("stream_inserts_total")
        self._obs_gauges()
        return res

    def _insert_impl(self, pts) -> "StreamingDBSCAN":
        batch = self._check_pts(pts, grow=True)
        b = batch.shape[0]
        obs_metrics.inc("stream_inserted_points_total", float(b))
        durability.barrier("pre-insert")    # crash: batch never durable
        if self._wal is not None:
            self._wal.append(batch.cpu().numpy(), self.n_points)
            durability.barrier("wal-durable")   # crash: durable, unapplied
        n_old = self.n_points
        gid0 = n_old
        dev = self.device

        # ---- bidirectional core-count update --------------------------
        c_new = torch.zeros(b, dtype=torch.int64, device=dev)
        for lvl in self._levels():          # vs every alive-masked level
            c_new += self._count(lvl, batch)
        c_new += _hits_blocked(batch, batch, self._eps2)  # within (incl self)
        new_counts = torch.clamp_max(c_new, self.min_pts).to(torch.int32)

        # existing *active* points eps-near the batch gain neighbors; the
        # eps-cell dilation filter is a sound superset of "within eps of a
        # batch point" (and a subset of the batch's eps-dilated AABB)
        all_pts = torch.cat([self._pts, batch]) if n_old else batch
        keys = fdbscan._cell_keys(all_pts, self.eps)
        batch_mask = torch.zeros(n_old + b, dtype=torch.bool, device=dev)
        batch_mask[n_old:] = True
        near = fdbscan._near_changed(keys, batch.shape[1], batch_mask)
        was_core = self._core
        aff = torch.nonzero(near[:n_old] & ~self._tombstone).flatten()
        if aff.numel():
            inc = _hits_blocked(self._pts[aff], batch, self._eps2)
            self._counts[aff] = torch.clamp_max(
                self._counts[aff] + inc, self.min_pts).to(torch.int32)

        # ---- append + buffer rebuild ----------------------------------
        self._pts = all_pts
        self._counts = torch.cat([self._counts, new_counts])
        self._tombstone = torch.cat(
            [self._tombstone, torch.zeros(b, dtype=torch.bool, device=dev)])
        core_now = (self._counts >= self.min_pts) & ~self._tombstone
        promoted = torch.nonzero(core_now[:n_old] & ~was_core).flatten()
        self._core = core_now
        new_gids = torch.arange(gid0, gid0 + b, dtype=torch.int64,
                                device=dev)
        self._labels = torch.cat([self._labels, new_gids.to(torch.int32)])
        self._buffer_gids = torch.cat([self._buffer_gids, new_gids])
        self._rebuild_buffer()

        # ---- incremental label repair ---------------------------------
        seed_mask = torch.zeros(self.n_points, dtype=torch.bool, device=dev)
        seed_mask[torch.cat([promoted, new_gids])] = True
        self._repair(self._core & seed_mask, keys, seed_new=True)
        self.n_inserts += 1

        # ---- compaction / merge policy --------------------------------
        self._maybe_compact()
        durability.barrier("post-insert")   # crash: applied, un-acked —
                                            # replay re-applies identically
        if self.window is not None and self.n_points > self.window:
            self.expire(self.n_points - self.window)
        return self

    def delete(self, ids) -> int:
        """Tombstone resident points by global insert id.

        Already-tombstoned ids are ignored (idempotent — WAL replay
        re-issues deletes); out-of-range or non-integer ids raise
        ValueError before anything is logged or applied. Returns the
        number of points newly tombstoned.

        With a WAL attached the delete is durably logged before any state
        changes, mirroring the insert barriers (``pre-delete``,
        ``wal-durable-delete``)."""
        gids = self._check_gids(ids)
        gids = gids[~self._tombstone[gids]]
        if gids.numel() == 0:
            return 0
        with obs_trace.span("stream.delete", k=gids.numel()):
            durability.barrier("pre-delete")  # crash: delete never durable
            if self._wal is not None:
                self._wal.append_delete(gids.cpu().numpy(), self.n_points,
                                        d=self._pts.shape[1])
                durability.barrier("wal-durable-delete")
            self._apply_delete(gids)
        self.n_deletes += 1
        obs_metrics.inc("stream_deletes_total", float(gids.numel()))
        self._obs_gauges()
        return gids.numel()

    def expire(self, watermark: int) -> int:
        """Tombstone every active point with insert id < ``watermark``
        (insert-order expiry — the sliding-window primitive). Idempotent;
        a watermark past ``n_points`` raises ValueError. Returns the
        number of points newly tombstoned."""
        wm = int(watermark)
        if wm > self.n_points:
            raise ValueError(f"expire watermark {wm} is past the stream "
                             f"end {self.n_points}")
        if wm > self._expire_watermark:
            self._expire_watermark = wm
        if wm <= 0:
            return 0
        gids = torch.nonzero(~self._tombstone[:wm]).flatten()
        if gids.numel() == 0:
            return 0
        with obs_trace.span("stream.expire", k=gids.numel()):
            durability.barrier("pre-delete")
            if self._wal is not None:
                self._wal.append_expire(wm, d=self._pts.shape[1])
                durability.barrier("wal-durable-delete")
            self._apply_delete(gids)
        self.n_deletes += 1
        obs_metrics.inc("stream_expired_points_total", float(gids.numel()))
        self._obs_gauges()
        return gids.numel()

    def merge(self) -> "StreamingDBSCAN":
        """Full compaction: fold every tier and the buffer into one main
        tier over the *active* points (tombstoned rows are dropped), via
        one Morton re-sort + LBVH rebuild padded to the same size buckets
        as the buffer. Index-only — labels, counts, and the core mask are
        untouched, so a merge can never change ``snapshot``."""
        act = self._alive_gids()
        n_act = act.numel()
        if (len(self._tiers) == 1 and self._buffer is None
                and int((self._tiers[0].gids >= 0).sum()) == n_act
                and self._live(self._tiers[0]) == n_act):
            return self                 # already a single clean main tier
        if n_act == 0 and not self._tiers and self._buffer is None:
            return self
        with obs_trace.span("stream.merge", n_active=n_act) as sp:
            new_main = (self._build_level(self._pts[act], act)
                        if n_act else None)
            durability.barrier("mid-merge")  # crash with the merge in
            self._tiers = [new_main] if new_main is not None else []
            self._buffer = None             # flight: all in-memory, the
            self._buffer_gids = self._gids(0)   # durable state is
            self.n_merges += 1              # unaffected
            if new_main is not None:
                sp.watch(new_main.segs, new_main.tree)
        obs_metrics.inc("stream_merges_total")
        self._obs_gauges()
        self._merges_since_ckpt += 1
        if (self._ckpt_path is not None and self._ckpt_every
                and self._merges_since_ckpt >= self._ckpt_every):
            self.checkpoint()
        return self

    def compact(self) -> "StreamingDBSCAN":
        """Tiered compaction step: seal the insert buffer into the newest
        delta tier, rewrite tiers that are mostly tombstones, and cascade
        same-size-class tier merges (classes grow ``growth``-fold from
        ``buffer_max``). Like :meth:`merge` this is index-only and drops
        tombstoned rows — label-invariant on survivors."""
        with obs_trace.span("stream.compact"):
            self._seal_buffer()
            self._drop_dead_tiers()
            self._cascade()
        self._obs_gauges()
        return self

    def snapshot(self, *, star: bool = False) -> DBSCANResult:
        """Materialized labels over the *active* point set (insertion
        order), component-identical to batch ``dbscan`` on exactly the
        surviving points: exact core mask, exact noise set, identical
        core partition; border points take the min adjacent core
        representative. ``star=True`` is DBSCAN* (no border points).
        The result's tensors live on the handle's device."""
        with obs_trace.span("stream.snapshot", star=star) as sp:
            res = self._snapshot_impl(star=star)
            sp.watch(res.labels, res.core_mask)
        return res

    def _snapshot_impl(self, *, star: bool) -> DBSCANResult:
        dev = self.device
        act = self._alive_gids()
        if act.numel() == 0:
            return DBSCANResult(
                labels=torch.zeros(0, dtype=torch.int32, device=dev),
                core_mask=torch.zeros(0, dtype=torch.bool, device=dev),
                n_clusters=0, n_sweeps=self.n_repair_sweeps,
                n_traversals=-1, backend="stream")
        core_full = self._core
        labels_full = torch.where(core_full, self._labels, -1).to(
            torch.int32)
        if not star:
            nb = act[~core_full[act]]
            if nb.numel() and bool(core_full.any()):
                vals = self._core_vals()
                acc = self._full(nb.numel(), INT_MAX)
                for lvl in self._levels():
                    acc, _ = self._run(lvl, self._pts[nb], vals, core_full,
                                       acc, mode="minlabel")
                labels_full[nb] = torch.where(acc == INT_MAX, -1, acc)
        core = core_full[act]
        labels_act = labels_full[act]
        uniq = torch.unique(labels_act[core])        # sorted ascending
        out = torch.full((act.numel(),), -1, dtype=torch.int32, device=dev)
        pos = labels_act >= 0
        out[pos] = torch.searchsorted(uniq, labels_act[pos]).to(torch.int32)
        return DBSCANResult(labels=out, core_mask=core,
                            n_clusters=int(uniq.numel()),
                            n_sweeps=self.n_repair_sweeps,
                            n_traversals=-1, backend="stream")

    # ------------------------------------------------------------------ #
    # durability (DESIGN.md §10)                                         #
    # ------------------------------------------------------------------ #

    def checkpoint(self, path: str | None = None) -> dict:
        """Atomically serialize the full handle state to ``path`` (default:
        the ``checkpoint_path`` the handle was built with).

        The checkpoint is a single ``.npz`` — points, saturated core
        counts, core mask, union-find labels, the tombstone mask, plus a
        manifest (format version, eps/min_pts, the insert-order and expiry
        watermarks, a content checksum) — written tmp-file + fsync +
        rename, so a crash during the write leaves the previous checkpoint
        intact. The format is the reference's, byte for byte: either
        package restores the other's checkpoints. A checkpoint written to
        the *configured* ``checkpoint_path`` (the file :meth:`restore`
        will read) also truncates the attached WAL — every logged record
        is now covered by the watermark; an ad-hoc side checkpoint to some
        other ``path`` leaves the WAL alone, so the records the configured
        path's recovery needs stay durable. Returns the manifest written.
        """
        path = path if path is not None else self._ckpt_path
        if path is None:
            raise ValueError("no checkpoint path: pass one to checkpoint() "
                             "or build the handle with checkpoint_path=")
        with obs_trace.span("stream.checkpoint", path=path):
            manifest = durability.save_checkpoint(self, path)
        if (self._ckpt_path is not None
                and os.path.realpath(path) == os.path.realpath(self._ckpt_path)):
            self._merges_since_ckpt = 0
            if self._wal is not None:
                self._wal.reset()
        return manifest

    @classmethod
    def restore(cls, checkpoint_path: str | None = None, *, wal=None,
                device=None, **kwargs) -> "StreamingDBSCAN":
        """Recover a live handle from durable state after a crash.

        Loads ``checkpoint_path`` (if the file exists), replays every WAL
        record past the checkpoint's watermark through the normal
        insert/delete/expire paths (deletes and expires are idempotent,
        so records the checkpoint already covers are harmless no-ops),
        and silently truncates a torn/corrupt WAL tail (an interrupted
        append was by definition never acknowledged). The recovered
        handle re-attaches both files and keeps serving.

        Args:
            checkpoint_path: checkpoint file written by :meth:`checkpoint`
                (may not exist yet — then recovery is WAL-only).
            wal: the write-ahead log path the crashed handle appended to.
            device: where the recovered handle lives (default the current
                CUDA device).
            **kwargs: handle options (``merge_ratio``, ``window``,
                ``buffer_max``, ``growth``, ``checkpoint_every``) for the
                recovered instance.

        Returns:
            A handle whose ``snapshot()`` is component-identical to batch
            ``dbscan`` on exactly the durable (acknowledged) surviving
            points.

        Raises:
            repro_torch.stream.durability.CheckpointError: the checkpoint
                file is corrupt or has an unknown format version.
            repro_torch.stream.durability.WALError: the WAL header is not
                ours.
            ValueError: neither file holds any state to recover.
        """
        wal_path = wal.path if isinstance(wal, durability.WriteAheadLog) \
            else wal
        return durability.recover(checkpoint_path, wal_path, device=device,
                                  **kwargs)

    def _host_arrays(self) -> dict:
        """Host (numpy) copies of the checkpointed state, in the
        reference's dtypes: what ``durability.save_checkpoint`` writes."""
        return {"pts": self._pts.cpu().numpy(),
                "counts": self._counts.cpu().numpy(),
                "core": self._core.cpu().numpy(),
                "labels": self._labels.cpu().numpy(),
                "tombstone": self._tombstone.cpu().numpy()}

    def _adopt_state(self, state: dict) -> None:
        """Install checkpointed arrays + rebuild the index from them (used
        by ``durability.recover``; no reclustering — labels, counts, core
        and tombstone masks are restored verbatim; the active points are
        deterministically rebuilt into a single main tier, which is
        index-only and therefore label-invariant)."""
        m = state["manifest"]
        pts = np.array(state["pts"], np.float32)
        if len(pts):
            check_points(pts, name="checkpoint points", dims=(2, 3))
        self._pts = self._tensor(pts)
        self._counts = self._tensor(np.array(state["counts"], np.int32))
        self._core = self._tensor(np.array(state["core"], bool))
        self._labels = self._tensor(np.array(state["labels"], np.int32))
        tomb = state.get("tombstone")
        if tomb is None:                     # v1 checkpoint: nothing dead
            tomb = np.zeros(len(pts), bool)
        self._tombstone = self._tensor(np.array(tomb, bool))
        self._n_tomb = int(self._tombstone.sum())
        self._expire_watermark = int(m.get("expire_watermark", 0))
        self.n_inserts = int(m["n_inserts"])
        self.n_deletes = int(m.get("n_deletes", 0))
        self.n_merges = int(m.get("n_merges", 0))
        self.n_compactions = int(m.get("n_compactions", 0))
        self.n_repair_sweeps = int(m["n_repair_sweeps"])
        act = self._alive_gids()
        self._tiers = ([self._build_level(self._pts[act], act)]
                       if act.numel() else [])
        self._buffer = None
        self._buffer_gids = self._gids(0)

    # ------------------------------------------------------------------ #
    # internals                                                          #
    # ------------------------------------------------------------------ #

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _gids(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.int64, device=self.device)

    def _full(self, n: int, value: int) -> torch.Tensor:
        return torch.full((n,), value, dtype=torch.int32, device=self.device)

    def _alive_gids(self) -> torch.Tensor:
        return torch.nonzero(~self._tombstone).flatten()

    def _core_vals(self) -> torch.Tensor:
        """Per gid: the label of a core point, INT_MAX elsewhere."""
        return torch.where(self._core, self._labels, INT_MAX).to(torch.int32)

    def _check_pts(self, pts, grow: bool) -> torch.Tensor:
        # an empty *probe* batch is a valid request (empty QueryResult,
        # matching neighbors.*); an empty *insert* batch is rejected
        checked = check_points(pts, name="points", dims=(2, 3),
                               allow_empty=not grow)
        # np.array (not asarray): never alias a caller-owned buffer the
        # caller may mutate after we have indexed its coordinates
        arr = np.array(checked, np.float32)
        if self.n_points and arr.shape[1] != self._pts.shape[1]:
            raise ValueError(f"dimensionality mismatch: index is "
                             f"{self._pts.shape[1]}-d, got {arr.shape[1]}-d")
        if grow and self.n_points == 0 and self._pts.shape[1] != arr.shape[1]:
            self._pts = torch.zeros((0, arr.shape[1]), dtype=torch.float32,
                                    device=self.device)
        return self._tensor(arr)

    def _check_gids(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        arr = np.asarray(ids)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        if arr.ndim != 1:
            raise ValueError(f"delete ids must be a flat sequence; got "
                             f"shape {arr.shape}")
        if arr.size == 0:
            return self._gids(0)
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"delete ids must be integers; got dtype "
                             f"{arr.dtype}")
        arr = arr.astype(np.int64)
        if arr.min() < 0 or arr.max() >= self.n_points:
            raise ValueError(f"delete ids must lie in [0, {self.n_points}); "
                             f"got range [{arr.min()}, {arr.max()}]")
        return self._tensor(np.unique(arr))

    def _bootstrap(self, pts: torch.Tensor, index) -> None:
        """Initial batch clustering via the fused pipeline (the walk kernel
        on the card), converted to global (insertion-order) ids with
        component-minimum reps."""
        n = pts.shape[0]
        dev = self.device
        if index is not None:
            segs, tree, walk_index = index
            if segs.n_points != n:
                raise ValueError(f"index covers {segs.n_points} points, "
                                 f"got {n}")
            if segs.pts.device != dev:
                raise ValueError(f"index lives on {segs.pts.device}, the "
                                 f"handle on {dev}")
            if bool(segs.dense_seg.any()):
                raise ValueError("streaming needs the plain (singleton) "
                                 "fdbscan index, not a densebox index")
            if tree is None:
                tree = dispatch._tree_of(segs)
        else:
            segs = grid.build_segments_fdbscan(pts)
            tree = dispatch._tree_of(segs)
            walk_index = None
        if walk_index is None:
            walk_index = dispatch._walk_index_of(segs, tree)
        self._pts = pts
        self._tombstone = torch.zeros(n, dtype=torch.bool, device=dev)
        self._n_tomb = 0
        order = segs.order.to(torch.int64)
        if n >= 2 and tree is not None:
            core_s, labels0, vals0, absorbed, tr = fdbscan._fused_first_pass(
                tree, segs, self.eps, self.min_pts, walk_index=walk_index)
            core_labels, _, _ = fdbscan._sweep_to_fixpoint(
                tree, segs, self.eps, core_s, labels0,
                fused_init=(vals0, absorbed), walk_index=walk_index)
            counts_s = torch.clamp_max(tr.hits + 1, self.min_pts).to(
                torch.int32)
            counts = torch.empty(n, dtype=torch.int32, device=dev)
            counts[order] = counts_s
            core = torch.empty(n, dtype=torch.bool, device=dev)
            core[order] = core_s
            labels = torch.arange(n, dtype=torch.int32, device=dev)
            if bool(core_s.any()):
                # sorted-space roots -> component-minimum *global* id, the
                # rep order the streaming hooks preserve (labels[i] <= i)
                roots = core_labels[core_s].to(torch.int64)
                rep_gid = torch.full((n,), n, dtype=torch.int64, device=dev)
                rep_gid.scatter_reduce_(0, roots, order[core_s], "amin")
                labels[order[core_s]] = rep_gid[roots].to(torch.int32)
        else:                       # n == 1
            counts = torch.ones(n, dtype=torch.int32, device=dev)
            core = counts >= self.min_pts
            labels = torch.zeros(n, dtype=torch.int32, device=dev)
        self._counts, self._core, self._labels = counts, core, labels
        self._tiers = [_Level(segs, tree, order, walk_index)]

    def _obs_gauges(self) -> None:
        """Mirror the handle's occupancy into the active registry; a
        no-op when no collector is installed."""
        if obs_metrics.active() is None:
            return
        obs_metrics.set_gauge("stream_active_points", float(self.n_active))
        obs_metrics.set_gauge("stream_tombstoned_points",
                              float(self.n_tombstoned))
        obs_metrics.set_gauge("stream_tiers", float(self.n_tiers))

    def _levels(self):
        yield from self._tiers
        if self._buffer is not None:
            yield self._buffer

    def _live(self, lvl: _Level) -> int:
        """Live (valid, non-tombstoned) primitives of one level."""
        g = lvl.gids
        valid = g >= 0
        if not bool(valid.any()):
            return 0
        return int((valid & ~self._tombstone[torch.where(valid, g, 0)]).sum())

    def _rebuild_buffer(self) -> None:
        bg = self._buffer_gids
        if bg.numel() == 0:
            self._buffer = None
            return
        self._buffer = self._build_level(self._pts[bg], bg)

    def _seal_buffer(self) -> None:
        """Freeze the insert buffer as the newest delta tier (dropping any
        tombstoned rows on the way)."""
        bg = self._buffer_gids
        bg = bg[~self._tombstone[bg]] if bg.numel() else bg
        self._buffer = None
        self._buffer_gids = self._gids(0)
        if bg.numel():
            self._tiers.append(self._build_level(self._pts[bg], bg))
            self.n_compactions += 1
            obs_metrics.inc("stream_compactions_total", kind="seal")

    def _tier_class(self, live: int) -> int:
        """Geometric size class of a tier: smallest c with
        live <= buffer_max * growth**c."""
        c, cap = 0, self._buffer_max
        while live > cap:
            cap *= self._growth
            c += 1
        return c

    def _cascade(self) -> None:
        """Merge the newest tier into its elder while they share a size
        class — the classic size-tiered LSM cascade. Tombstoned rows are
        dropped by the rebuild; the merge is index-only."""
        while len(self._tiers) >= 2:
            a, b = self._tiers[-2], self._tiers[-1]
            if self._tier_class(self._live(b)) < self._tier_class(self._live(a)):
                break
            ga, gb = a.gids[a.gids >= 0], b.gids[b.gids >= 0]
            g = torch.cat([ga[~self._tombstone[ga]],
                           gb[~self._tombstone[gb]]])
            new = self._build_level(self._pts[g], g) if g.numel() else None
            durability.barrier("mid-compaction")    # all in-memory: the
            self._tiers = self._tiers[:-2] + (      # durable state is
                [new] if new is not None else [])   # unaffected
            self.n_compactions += 1
            obs_metrics.inc("stream_compactions_total", kind="cascade")

    def _drop_dead_tiers(self) -> None:
        """Rewrite (or drop) tiers whose tombstone fraction reached
        ``_TOMB_MAX_FRAC`` — bounds space amplification after deletes."""
        out = []
        for lvl in self._tiers:
            g = lvl.gids[lvl.gids >= 0]
            total = g.numel()
            dead = int(self._tombstone[g].sum()) if total else 0
            if dead == 0 or (total - dead) > total * _TOMB_MAX_FRAC:
                out.append(lvl)
                continue
            durability.barrier("mid-compaction")
            self.n_compactions += 1
            obs_metrics.inc("stream_compactions_total", kind="rewrite")
            live = g[~self._tombstone[g]]
            if live.numel():
                out.append(self._build_level(self._pts[live], live))
        self._tiers = out

    def _maybe_compact(self) -> None:
        """Post-insert policy: full merge when the whole delta outgrows
        ``merge_ratio`` times the main; otherwise seal + cascade when the
        buffer outgrows its budget."""
        if self.n_delta > max(MERGE_MIN,
                              int(self._merge_ratio * self.n_main)):
            self.merge()
            return
        bg = self._buffer_gids
        n_buf = int((~self._tombstone[bg]).sum()) if bg.numel() else 0
        if n_buf > self._buffer_max:
            self.compact()

    def _apply_delete(self, gids: torch.Tensor) -> None:
        """Tombstone ``gids`` (all alive), recount the survivors around
        them exactly, and run demotion repair (DESIGN.md §11).

        Order matters: rows are tombstoned *before* the recount so the
        alive-masked walks no longer see them, and the old component
        representatives of dying/demoted cores are captured *before* any
        label is reset."""
        n = self.n_points
        d = self._pts.shape[1]
        dev = self.device
        old_core = self._core.clone()
        dead_core = gids[old_core[gids]]
        rep_dead = self._labels[dead_core]          # old reps of dead cores

        self._tombstone[gids] = True
        self._n_tomb += gids.numel()
        self._counts[gids] = 0
        self._core[gids] = False
        self._labels[gids] = gids.to(torch.int32)

        # exact recount of surviving points eps-near a deleted row — the
        # saturated counts cannot be decremented (min(c, mp) loses the
        # overshoot), and the eps-cell dilation is the same sound superset
        # the insert path uses
        keys = fdbscan._cell_keys(self._pts, self.eps)
        dead_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        dead_mask[gids] = True
        near = fdbscan._near_changed(keys, d, dead_mask)
        aff = torch.nonzero(near & ~self._tombstone).flatten()
        demoted = self._gids(0)
        if aff.numel():
            cnt = torch.zeros(aff.numel(), dtype=torch.int64, device=dev)
            for lvl in self._levels():  # each gid resides in exactly one
                cnt += self._count(lvl, self._pts[aff])     # level, so the
            # sum counts the point's own resident copy exactly once —
            # matching the counts-include-self convention
            new_c = torch.clamp_max(cnt, self.min_pts).to(torch.int32)
            now = new_c >= self.min_pts
            # deletion only removes neighbors: was-False implies an exact
            # (unsaturated) old count below min_pts, so now is never True
            # where was is False — no promotions, only demotions
            demoted = aff[old_core[aff] & ~now]
            self._counts[aff] = new_c
            self._core[aff] = old_core[aff] & now
        rep_demoted = self._labels[demoted]         # still the old reps
        self._labels[demoted] = demoted.to(torch.int32)

        # demotion repair: a removed/demoted core can split its component,
        # and min-label propagation can only shrink labels — so reset every
        # surviving core of every affected component to its own gid and
        # re-derive by exact frontier sweeps. Cores of unaffected
        # components are provably >eps from every affected one (two cores
        # within eps share a component), so their labels stay fixed.
        reps = torch.unique(torch.cat([rep_dead, rep_demoted]))
        if reps.numel():
            reset = self._core & torch.isin(self._labels, reps)
            ridx = torch.nonzero(reset).flatten()
            self._labels[ridx] = ridx.to(torch.int32)
            self._repair(reset, keys, seed_new=False)

        # compact away the garbage: drop dead rows from the buffer, rewrite
        # mostly-dead tiers, and re-check the cascade classes
        bg = self._buffer_gids
        if bg.numel() and bool(self._tombstone[bg].any()):
            self._buffer_gids = bg[~self._tombstone[bg]]
            self._rebuild_buffer()
        self._drop_dead_tiers()
        self._cascade()

    def _build_level(self, dpts: torch.Tensor, gids: torch.Tensor) -> _Level:
        """Index build over ``dpts`` (global ids ``gids``), padded to a
        bucketed size with out-of-range sentinels (gid -1) — the
        reference's padding, so a level is the same index in both
        packages — and packed once for the walk kernel on the card."""
        nd, d = dpts.shape
        pad = max(fdbscan._pad_size(nd), 2)
        lo, hi = dpts.amin(0), dpts.amax(0)
        if pad > nd:
            sent = hi + torch.tensor(_SENTINEL_EPS * self.eps,
                                     dtype=torch.float32, device=self.device)
            dpts = torch.cat([dpts, sent.expand(pad - nd, d)])
            gids = torch.cat([gids, torch.full((pad - nd,), -1,
                                               dtype=torch.int64,
                                               device=self.device)])
        segs, tree = _build_index(dpts, lo, hi)
        return _Level(segs, tree, gids[segs.order.to(torch.int64)],
                      dispatch._walk_index_of(segs, tree))

    def _count(self, lvl: _Level, qpts: torch.Tensor) -> torch.Tensor:
        """eps-neighbor count (int64) of external queries against the
        *live* residents of one level.

        A clean level (no sentinels, no tombstoned rows) uses plain
        ``count`` mode (early exit at min_pts); otherwise the masked fused
        count (``count_minlabel``'s hits) — a sentinel or dead row can
        never enter it, while a probe may legitimately live anywhere,
        including near a sentinel's coordinates."""
        valid = lvl.gids >= 0
        k = qpts.shape[0]
        if lvl.tree is None:
            gv = lvl.gids[valid]
            gv = gv[~self._tombstone[gv]]
            if gv.numel() == 0:
                return torch.zeros(k, dtype=torch.int64, device=self.device)
            return torch.clamp_max(
                _hits_blocked(qpts, self._pts[gv], self._eps2), self.min_pts)
        alive = ~self._tombstone
        clean = bool(valid.all()) and bool(alive[lvl.gids].all())
        if clean:
            acc, _ = self._run(lvl, qpts, None, None, self._full(k, 0),
                               mode="count", cap=self.min_pts)
            return acc.to(torch.int64)
        _, hits = self._run(lvl, qpts, self._full(self.n_points, 0), alive,
                            self._full(k, INT_MAX), mode="count_minlabel",
                            cap=self.min_pts)
        return hits

    def _run(self, lvl: _Level, qpts: torch.Tensor, vals, mask,
             init: torch.Tensor, mode: str, cap: int = INT_MAX):
        """One external-query pass against one level; (acc int32, hits
        int64) per query. ``init`` seeds the visitor's carry, chaining
        the running accumulator across levels. ``mask`` is indexed by gid —
        callers pass the core mask (never true for tombstoned rows) or an
        explicit alive mask, so dead residents can never be gathered;
        ``count`` mode reads neither ``vals`` nor ``mask``."""
        k = qpts.shape[0]
        dev = self.device
        valid = lvl.gids >= 0
        if lvl.tree is None:        # <2 residents: trivial brute force
            gv = lvl.gids[valid]
            if gv.numel() == 0:
                return init.clone(), torch.zeros(k, dtype=torch.int64,
                                                 device=dev)
            # (only the min-label modes come here: _count takes a
            # tree-less level itself)
            res = self._pts[gv]
            hit = _dist2_eager(qpts[:, None, :] - res[None]) <= self._eps2
            ok = hit & mask[gv][None]
            vv = torch.where(ok, vals[gv][None].to(torch.int64), INT_MAX)
            acc = torch.minimum(init.to(torch.int64), vv.amin(1))
            return acc.to(torch.int32), ok.sum(1)
        # every distinct (mode, level shape, probe bucket, cap) tuple is
        # one compiled walk program in the reference; see _note_program
        _note_program((mode, qpts.shape[1], fdbscan._pad_size(k),
                       lvl.gids.shape[0], cap))
        node_mask = None
        if mode == "count":         # count needs every resident; the
            cb = traversal.CountVisitor(cap=cap)    # others prune to mask
        else:
            gsafe = torch.clamp_min(lvl.gids, 0)
            pv = torch.where(valid, vals[gsafe], INT_MAX).to(torch.int32)
            pm = valid & mask[gsafe]
            node_mask = lbvh.propagate_leaf_flags(lvl.tree, pm)
            if mode == "minlabel":
                cb = traversal.MinLabelVisitor(pv, pm)
            else:
                cb = traversal.CountMinLabelVisitor(pv, pm, cap=cap)
        preds = traversal.intersects(
            traversal.sphere(self.eps),
            ids=torch.zeros(k, dtype=torch.int32, device=dev), pts=qpts)
        carry = traversal.AccHits(
            acc=init.to(torch.int32).contiguous(),
            hits=torch.zeros(k, dtype=torch.int32, device=dev))
        tr = fdbscan._walk(lvl.tree, lvl.segs, preds, cb, carry=carry,
                           node_mask=node_mask, walk_index=lvl.walk_index)
        return tr.acc, tr.hits.to(torch.int64)

    def _repair(self, q_mask: torch.Tensor, keys: torch.Tensor, *,
                seed_new: bool) -> None:
        """Incremental union-find repair from a seed query mask.

        Insert (``seed_new=True``): every new core-core edge has an
        endpoint in the seed (the batch + promotions). Sweep 1 runs *only
        the seed cores* as queries, each gathering over the full core set
        — the expensive direction of every new edge is covered once, by
        its seed endpoint. The reverse direction needs no sweep-1 query: a
        seed's label is a new entry in the label pool, so the whole seed
        is marked changed after sweep 1 regardless of whether its *value*
        moved, and the standard frontier restriction (gather only from
        changed points, query only core points eps-near a change, prune
        unchanged subtrees) lets the neighbors pull it in sweep 2 at
        masked-gather cost.

        Delete (``seed_new=False``): the seed is the reset set of demotion
        repair — every surviving core of every affected component, whose
        labels were just reset to their own gids. Sweep 1 gathers the
        current labels for the whole reset set at once (an eps-edge from a
        reset core can only reach another reset core), so no
        forced-changed marking is needed; later sweeps run the same exact
        frontier restriction.

        From sweep 2 on this is exactly ``fdbscan._sweep_to_fixpoint``'s
        loop, started from the old fixpoint instead of from scratch."""
        if not bool(q_mask.any()):
            return                  # no seed cores => no edges to repair
        d = self._pts.shape[1]
        core = self._core
        gather = core               # sweep 1 gathers over every core point
        labels = self._labels
        first = True
        with obs_trace.span("stream.repair", seed=int(q_mask.sum())):
            while True:
                q = torch.nonzero(q_mask).flatten()
                if q.numel() == 0:
                    break
                acc = self._full(q.numel(), INT_MAX)
                for lvl in self._levels():
                    acc, _ = self._run(lvl, self._pts[q], labels, gather,
                                       acc, mode="minlabel")
                new = labels.clone()
                new[q] = torch.minimum(labels[q], acc)
                new = unionfind.jump_to_fixpoint(new)
                changed = new != labels
                if first and seed_new:  # seed labels are new to the pool:
                    changed |= q_mask   # neighbors must gather them once
                first = False
                labels = new
                self.n_repair_sweeps += 1
                obs_metrics.inc("stream_repair_sweeps_total")
                if not bool(changed.any()):
                    break
                gather = changed & core
                q_mask = core & fdbscan._near_changed(keys, d, changed)
        self._labels = labels
