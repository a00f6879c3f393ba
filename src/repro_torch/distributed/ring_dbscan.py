"""Distributed DBSCAN over the shards of a mesh (beyond-paper).

The port of ``repro.distributed.ring_dbscan``. The paper's §6 lists
distribution as future work; this module carries two multi-shard
strategies over the same outer protocol (global Morton sort, contiguous
slabs over the mesh's data axis, all-gather + pointer-jumping label
fixpoint):

* :func:`ring_dbscan` — the dense *ring systolic* baseline: every phase
  rotates full point blocks and runs an O(n^2/P) pairwise tile per step.
  None of the tree machinery reaches it; it survives as the small-n
  fallback and the comparator for the sharded path's work.

* :func:`tree_dbscan_sharded` — the tree-based path (DESIGN.md §6): each
  shard Morton-resorts its slab locally and builds a singleton-segment
  LBVH over it; queries (not primitives) travel the ring, and at each stop
  only the **eps-halo** — traveling points within ``eps`` of the resident
  slab's AABB — walks the local tree (``sharding.halo_mask``). Everything
  else is inert before the root box test, so per-shard work collapses from
  the dense n^2/P tile to the sequential tree bound plus a boundary-slab
  term, while the label fixpoint (all-gather + pointer jumping) is
  unchanged.

Union-find across shards: labels are global (Morton-sorted) indices;
after each hook sweep, labels are all-gathered and pointer jumping runs
locally to a fixpoint. Sweeps repeat until a global sum reports no change.

A mesh (``sharding.LocalMesh``, ``sharding.GroupMesh``) takes the place of
the reference's ``shard_map``: the programs below are written over the
shards a process holds (all P of a local mesh, one a rank of a group
mesh) and the mesh's three collectives. Every walk is
``repro_torch.kernels.traverse.traverse``: the walk kernel on CUDA
tensors, the plain engine on the CPU. A halo walk takes only its active
lanes (the others would be inert lanes, which walk nothing), so a stop
with no halo launches nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import grid, lbvh, morton, traversal
from repro_torch.core.dispatch import as_points, resolve_device
from repro_torch.core.fdbscan import DBSCANResult, _finalize
from repro_torch.kernels import pairwise, ref
from repro_torch.kernels import traverse as ktraverse
from . import sharding

INT_MAX = 2**31 - 1
# Padding rows sit here: farther than any eps from every real point.
SENTINEL = 1e30
# The sentinel Morton code of a shard's padding rows (sorts last).
SENTINEL_CODE = 0xFFFFFFFF
_ROWS = 1024        # query rows a block of the difference-form tiles


def default_mesh(axis: str = "data"):
    """The mesh a distributed call runs on when given none: the
    ``torch.distributed`` world where one is initialised (a
    :class:`sharding.GroupMesh`), else one shard in this process (the
    reference's default, all devices, on one device)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return sharding.GroupMesh(axis=axis)
    return sharding.LocalMesh(1, axis)


def _diff_e2(eps) -> float:
    """The difference-form tiles' threshold: ``eps * eps`` in double,
    rounded once to float32 (the reference squares the Python float and
    compares float32 distances against it)."""
    return float(np.float32(float(eps) * float(eps)))


def _diff_d2(q, r):
    """(nq, nr) float32 squared distances ``sum((q - r) ** 2)``, rounded as
    the reference's compiled code rounds them (``ref.tile_sum_sq``)."""
    return ref.tile_sum_sq(q[:, None, :] - r[None, :, :])


def _count_tile(q, r, eps):
    """The reference's ``_count_tile``: references within eps a query."""
    e2 = _diff_e2(eps)
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for lo in range(0, q.shape[0], _ROWS):
        d2 = _diff_d2(q[lo:lo + _ROWS], r)
        out[lo:lo + _ROWS] = (d2 <= e2).sum(1, dtype=torch.int32)
    return out


def _minlabel_tile(q, r, labels_r, mask_r, eps):
    """The reference's ``_minlabel_tile``: the min masked label within eps
    a query (INT_MAX where none)."""
    e2 = _diff_e2(eps)
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for lo in range(0, q.shape[0], _ROWS):
        ok = (_diff_d2(q[lo:lo + _ROWS], r) <= e2) & mask_r[None, :]
        out[lo:lo + _ROWS] = torch.where(ok, labels_r[None, :],
                                         INT_MAX).amin(1)
    return out


def _kernel_minlabel(q, r, labels_r, mask_r, eps):
    return pairwise.pairwise_minlabel(q, r, labels_r, mask_r, eps)[0]


def _axis_or_raise(mesh, axis: str) -> int:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    return sharding._axis_size(mesh, axis)


def _pad(points: torch.Tensor, ndev: int):
    """Global Morton sort, then sentinel rows up to a multiple of ``ndev``.
    Returns (padded sorted points, order, n_pad)."""
    n = points.shape[0]
    pts_sorted, order, _ = morton.morton_sort(points)
    n_pad = ((n + ndev - 1) // ndev) * ndev
    pad = torch.full((n_pad - n, points.shape[1]), SENTINEL,
                     dtype=pts_sorted.dtype, device=pts_sorted.device)
    return torch.cat([pts_sorted, pad]), order, n_pad


def _slabs(mesh, axis: str, pts_pad: torch.Tensor, n_loc: int) -> list:
    """The held shards' slabs of the padded sorted points."""
    return [pts_pad[s * n_loc:(s + 1) * n_loc] for s in mesh.held(axis)]


def _slab_ids(mesh, axis: str, n: int, n_loc: int, dev) -> tuple:
    """(global ids, valid-row masks) of the held shards' slabs."""
    gid = [s * n_loc + torch.arange(n_loc, dtype=torch.int32, device=dev)
           for s in mesh.held(axis)]
    return gid, [g < n for g in gid]


def _jump(mesh, axis: str, labels: list) -> list:
    """All-gather + pointer jumping to the fixpoint (labels are global
    sorted indices; chains strictly decrease, so this terminates)."""
    while True:
        table = mesh.all_gather(axis, labels)
        new = []
        for lab in labels:
            none = lab == INT_MAX
            safe = torch.where(none, 0, lab).long()
            new.append(torch.where(none, lab, table[safe]))
        changed = mesh.psum(axis, [(a != b).any() for a, b in
                                   zip(new, labels)])
        labels = new
        if not changed:
            return labels


def _result(mesh, axis: str, labels: list, core: list, order, n: int,
            n_sweeps: int, backend: str) -> DBSCANResult:
    """The whole result from the held shards' labels and core flags."""
    labels_sorted = mesh.all_gather(axis, labels)[:n]
    core_sorted = mesh.all_gather(axis, core)[:n]
    out, n_clusters = _finalize(labels_sorted, order, n)
    core_mask = torch.zeros(n, dtype=torch.bool, device=out.device)
    core_mask[order.long()] = core_sorted
    return DBSCANResult(labels=out, core_mask=core_mask,
                        n_clusters=n_clusters, n_sweeps=n_sweeps,
                        backend=backend)


def ring_dbscan(points, eps: float, min_pts: int, mesh=None,
                axis: str = "data", use_pallas: bool | None = None,
                max_jump: int = 32, *, device=None) -> DBSCANResult:
    """Dense ring DBSCAN over the shards of ``mesh``'s ``axis``.

    Each phase (count, every hook sweep, borders) rotates the full point
    blocks round the ring and runs one pairwise tile a step.

    The tiles: ``use_pallas=True`` takes the tile kernels
    (``kernels.pairwise``: ``pairwise_count``, ``pairwise_minlabel``; the
    arithmetic of the reference's ``use_pallas=True``), which on CPU
    tensors are their plain versions; ``use_pallas=False`` the reference's
    difference form (``sum((q - r) ** 2)``), written in plain PyTorch. The
    card has no plain tile: on a CUDA device the default (``None``) is the
    kernels and ``use_pallas=False`` raises ``ValueError``; on the CPU the
    default is the difference form, as the reference's.

    Args:
        points: (n, d) points (computed in float32).
        eps, min_pts: the DBSCAN parameters.
        mesh: a ``sharding.LocalMesh`` or ``GroupMesh``; default
            :func:`default_mesh`.
        axis: the mesh axis the points are split over.
        use_pallas: the tiles, as above.
        max_jump: unused; kept for the reference's signature.
        device: where the shards live and the tiles run; default the
            current CUDA device (``RuntimeError`` if there is none).

    Returns:
        A :class:`DBSCANResult` with ``backend="ring"``.
    """
    dev = resolve_device(device)
    if use_pallas is None:
        use_pallas = dev.type == "cuda"
    elif not use_pallas and dev.type == "cuda":
        raise ValueError("ring_dbscan: use_pallas=False needs CPU tensors: "
                         "on a CUDA device the tiles are the tile kernels")
    points = as_points(points, dev)
    n = points.shape[0]
    if mesh is None:
        mesh = default_mesh(axis)
    ndev = _axis_or_raise(mesh, axis)
    pts_pad, order, n_pad = _pad(points, ndev)
    n_loc = n_pad // ndev
    count_tile = pairwise.pairwise_count if use_pallas else _count_tile
    minlabel_tile = _kernel_minlabel if use_pallas else _minlabel_tile
    local = _slabs(mesh, axis, pts_pad, n_loc)
    gid, valid = _slab_ids(mesh, axis, n, n_loc, dev)
    full = [torch.full((n_loc,), INT_MAX, dtype=torch.int32, device=dev)
            for _ in local]

    # ---- phase 1 (preprocessing): ring neighbor count --------------------
    counts = [torch.zeros(n_loc, dtype=torch.int32, device=dev)
              for _ in local]
    blocks = [(x,) for x in local]
    for _ in range(ndev):
        counts = [c + count_tile(q, b[0], eps)
                  for c, q, b in zip(counts, local, blocks)]
        blocks = mesh.rotate(axis, blocks)
    core = [(c >= min_pts) & v for c, v in zip(counts, valid)]

    def ring(vals):
        """One rotation of (points, vals, core) blocks; the min gathered
        label a resident query."""
        best = list(full)
        blocks = list(zip(local, vals, core))
        for _ in range(ndev):
            best = [torch.minimum(b, minlabel_tile(q, *blk, eps))
                    for b, q, blk in zip(best, local, blocks)]
            blocks = mesh.rotate(axis, blocks)
        return best

    # ---- phase 2 (main): ring hook sweeps + global pointer jumping -------
    labels = [torch.where(c, g, INT_MAX) for c, g in zip(core, gid)]
    n_sweeps = 0
    while True:
        best = ring(labels)
        new = [torch.where(c, torch.minimum(lab, b), lab)
               for c, lab, b in zip(core, labels, best)]
        new = _jump(mesh, axis, new)
        changed = mesh.psum(axis, [(a != b).any() for a, b in
                                   zip(new, labels)])
        labels = new
        n_sweeps += 1
        if not changed:
            break

    # ---- borders: one more ring pass over core roots ---------------------
    best = ring([torch.where(c, lab, INT_MAX)
                 for c, lab in zip(core, labels)])
    labels = [torch.where(c, lab, torch.where(v, b, INT_MAX))
              for c, lab, v, b in zip(core, labels, valid, best)]
    labels = [torch.where(lab == INT_MAX, -1, lab) for lab in labels]
    return _result(mesh, axis, labels, core, order, n, n_sweeps, "ring")


class ShardIndex:
    """One shard's resident index: its slab Morton-resorted with the
    shard's own bounds and the singleton-segment LBVH over it."""

    def __init__(self, local: torch.Tensor, valid: torch.Tensor):
        self.lo, self.hi = sharding.shard_bounds(local, valid)
        codes = morton.morton_encode(local, lo=self.lo, hi=self.hi)
        codes = torch.where(valid, codes, SENTINEL_CODE)
        # a stable sort, as jnp.argsort: equal codes keep slab order
        self.lorder = torch.argsort(codes, stable=True)
        lpts = local[self.lorder]
        self.segs = grid.singleton_segments(
            lpts, self.lorder.to(torch.int32), codes[self.lorder])
        self.tree = lbvh.build_tree(self.segs.codes, self.segs.prim_lo,
                                    self.segs.prim_hi)
        self.lvalid = valid[self.lorder]


class Forest:
    """The held shards' trees packed into one index, so that one walk (one
    kernel launch on the card) serves every held shard's stop of a ring
    step: each lane starts at its resident shard's root (the walk's
    ``root=``), and a tree's rope out of its root is -1, so a lane never
    leaves its shard's tree.

    Node numbering keeps the index's rule (internal nodes first, then the
    leaves): shard k's internal node i is ``k * (n_loc - 1) + i`` and its
    leaf j is ``(M - 1) + k * n_loc + j`` over M = H * n_loc leaves; the
    H - 1 internal slots left over are unreachable padding. Points are the
    shards' locally sorted slabs, in held order. With one held shard the
    forest is that shard's index and every lane starts at node 0. On a
    CUDA device the forest carries the walk kernel's packed layout.
    """

    def __init__(self, index: list):
        h = len(index)
        n_loc = index[0].segs.n_points
        n_int, m = n_loc - 1, h * n_loc
        dev = index[0].segs.pts.device
        if h == 1:
            self.segs, self.tree = index[0].segs, index[0].tree
            self.roots = None
        else:
            def remap(x, k):
                leaf = x - n_int + (m - 1) + k * n_loc
                return torch.where(x < 0, x, torch.where(x < n_int,
                                                         x + k * n_int, leaf))

            pad_i = torch.full((h - 1,), -1, dtype=torch.int32, device=dev)

            def nodes(field, fix, pad):
                """A per-node field: internal parts, padding, leaf parts."""
                parts = [fix(getattr(x.tree, field), k)
                         for k, x in enumerate(index)]
                return torch.cat([p[:n_int] for p in parts] + [pad]
                                 + [p[n_int:] for p in parts])

            d = index[0].segs.pts.shape[1]
            inf = torch.full((h - 1, d), float("inf"), device=dev)
            lpts = torch.cat([x.segs.pts for x in index])
            self.segs = grid.singleton_segments(
                lpts,
                torch.cat([x.segs.order + k * n_loc
                           for k, x in enumerate(index)]),
                torch.cat([x.segs.codes for x in index]))
            self.tree = lbvh.Tree(
                left=torch.cat([remap(x.tree.left, k)
                                for k, x in enumerate(index)] + [pad_i]),
                right=torch.cat([remap(x.tree.right, k)
                                 for k, x in enumerate(index)] + [pad_i]),
                parent=nodes("parent", remap, pad_i),
                miss=nodes("miss", remap, pad_i),
                range_r=nodes("range_r", lambda r, k: r + k * n_loc, pad_i),
                box_lo=nodes("box_lo", lambda b, k: b, inf),
                box_hi=nodes("box_hi", lambda b, k: b, -inf))
            self.roots = torch.arange(h, dtype=torch.int32,
                                      device=dev) * n_int
        self.walk_index = None
        if dev.type == "cuda":
            from repro_torch.kernels.walkpack import pack_index
            self.walk_index = pack_index(self.tree, self.segs)


class ShardedProgram:
    """The sharded tree path's three per-shard phases over a mesh — build
    (index + traveling-query count), sweep (one traveling min-label sweep
    + pointer jumping + change sum) and border — the port of the
    reference's ``_sharded_programs``.

    Each phase takes and returns one entry a held shard (lists in
    ``mesh.held(axis)`` order); ``evals`` are per-lane member distance
    evaluations, home-aligned like the reference's sharded outputs.
    """

    def __init__(self, mesh, axis: str, n: int, n_pad: int, eps: float,
                 min_pts: int):
        self.mesh, self.axis = mesh, axis
        self.n, self.eps, self.min_pts = n, float(eps), int(min_pts)
        self.ndev = sharding._axis_size(mesh, axis)
        self.n_loc = n_pad // self.ndev
        self.held = mesh.held(axis)

    def slab_ids(self, dev):
        """(global ids, valid masks) of the held shards' slabs."""
        return _slab_ids(self.mesh, self.axis, self.n, self.n_loc, dev)

    def _stop(self, forest: Forest, index: list, blocks: list, callback,
              seeded: bool) -> list:
        """One ring stop of every held shard: the halo lanes of each
        traveling block (``(points, on, acc, evals)``) walk the resident
        shard's tree as external queries, all in one walk of the forest.
        A count adds the stop's count to ``acc``; a seeded min-label walk
        starts from ``acc`` (a query chains its running answer across
        successive shard visits this way). Lanes outside the halo keep
        their ``acc``."""
        active = torch.stack([
            on & sharding.halo_mask(pts, idx.lo, idx.hi, self.eps)
            for idx, (pts, on, _, _) in zip(index, blocks)])
        k, lane = torch.nonzero(active, as_tuple=True)
        if k.numel() == 0:
            return blocks
        acc = torch.stack([b[2] for b in blocks])
        evals = torch.stack([b[3] for b in blocks])
        pred = traversal.intersects(
            traversal.sphere(self.eps),
            ids=torch.zeros(k.shape[0], dtype=torch.int32, device=k.device),
            pts=torch.stack([b[0] for b in blocks])[k, lane])
        carry = None
        if seeded:
            a = acc[k, lane]
            carry = traversal.AccHits(acc=a, hits=torch.zeros_like(a))
        tr = ktraverse.traverse(
            forest.tree, forest.segs, pred, callback, carry=carry,
            walk_index=forest.walk_index,
            root=None if forest.roots is None else forest.roots[k])
        if seeded:
            acc[k, lane] = tr.acc
        else:
            acc[k, lane] += tr.acc
        evals[k, lane] += tr.evals
        return [(b[0], b[1], acc[i], evals[i]) for i, b in enumerate(blocks)]

    def build(self, local: list):
        """Per-shard index build + the traveling-query count phase.
        Returns ((indexes, forest), core, labels0, evals)."""
        dev = local[0].device
        gid, valid = self.slab_ids(dev)
        index = [ShardIndex(x, v) for x, v in zip(local, valid)]
        forest = Forest(index)
        zero = torch.zeros(self.n_loc, dtype=torch.int32, device=dev)
        blocks = [(x, v, zero, zero) for x, v in zip(local, valid)]
        count = traversal.CountVisitor(cap=self.min_pts)
        for _ in range(self.ndev):
            blocks = self._stop(forest, index, blocks, count, False)
            blocks = self.mesh.rotate(self.axis, blocks)
        core = [(b[2] >= self.min_pts) & v for b, v in zip(blocks, valid)]
        labels0 = [torch.where(c, g, INT_MAX) for c, g in zip(core, gid)]
        return (index, forest), core, labels0, [b[3] for b in blocks]

    def _minlabel_rotation(self, local, idx, point_vals, gather_mask,
                           blk_on, acc0):
        """Rotate ``(queries, acc)`` round the full ring, gathering the min
        of ``point_vals`` over masked resident neighbors at each halo stop.
        Returns (best, evals) home-aligned — shared by the sweep and border
        phases (same protocol, different values and queries)."""
        index, forest = idx
        zero = torch.zeros(self.n_loc, dtype=torch.int32,
                           device=local[0].device)
        visitor = traversal.MinLabelVisitor(torch.cat(point_vals),
                                            torch.cat(gather_mask))
        blocks = [(x, on, a, zero) for x, on, a in zip(local, blk_on, acc0)]
        for _ in range(self.ndev):
            blocks = self._stop(forest, index, blocks, visitor, True)
            blocks = self.mesh.rotate(self.axis, blocks)
        return [b[2] for b in blocks], [b[3] for b in blocks]

    def sweep(self, local, idx, core, labels):
        """One traveling min-label sweep + pointer jumping + change sum.
        Returns (labels, changed, evals)."""
        index = idx[0]
        _, valid = self.slab_ids(local[0].device)
        best, evals = self._minlabel_rotation(
            local, idx,
            [lab[i.lorder] for lab, i in zip(labels, index)],
            [c[i.lorder] & i.lvalid for c, i in zip(core, index)],
            [v & c for v, c in zip(valid, core)], labels)
        new = [torch.where(c, torch.minimum(lab, b), lab)
               for c, lab, b in zip(core, labels, best)]
        new = _jump(self.mesh, self.axis, new)
        changed = self.mesh.psum(self.axis, [(a != b).any() for a, b in
                                             zip(new, labels)])
        return new, bool(changed), evals

    def border(self, local, idx, core, labels):
        """Borders: one rotation of the non-core queries over core roots.
        Returns (labels, evals)."""
        index = idx[0]
        _, valid = self.slab_ids(local[0].device)
        full = torch.full((self.n_loc,), INT_MAX, dtype=torch.int32,
                          device=local[0].device)
        best, evals = self._minlabel_rotation(
            local, idx,
            [torch.where(c[i.lorder], lab[i.lorder], INT_MAX)
             for c, lab, i in zip(core, labels, index)],
            [c[i.lorder] & i.lvalid for c, i in zip(core, index)],
            [v & ~c for v, c in zip(valid, core)], [full] * len(local))
        out = [torch.where(c, lab, torch.where(v, b, INT_MAX))
               for c, lab, v, b in zip(core, labels, valid, best)]
        return [torch.where(lab == INT_MAX, -1, lab) for lab in out], evals


def tree_dbscan_sharded(points, eps: float, min_pts: int, mesh=None,
                        axis: str = "data", with_stats: bool = False, *,
                        device=None):
    """Shard-local LBVH walks + eps-halo exchange (DESIGN.md §6).

    Protocol per phase (count / sweep / border): the shard's slab of the
    globally Morton-sorted points travels the ring as *external queries*;
    at each of the ``ndev`` stops, the traveling points inside the resident
    shard's eps-dilated AABB (``sharding.halo_mask`` — the halo) walk the
    resident tree, and the per-query partial result (count or running min
    label) travels on with the block. After a full rotation the block is
    home carrying its global answer. Exchanged points are *queries*, not
    tree primitives: no shard ever rebuilds its index for foreign points.

    Per-visit neighbor counts saturate at ``min_pts``; the home-shard sum of
    the saturated per-visit counts crosses ``min_pts`` iff the true global
    count does, so the early exit survives distribution.

    The sweep fixpoint is driven from the host, one sweep a call, like the
    reference's host loop; ``n_sweeps`` counts the last, unchanged sweep.
    Each shard's index is built once. Inputs too small for a tree a shard
    (fewer than two rows a shard) take :func:`ring_dbscan`.

    Args:
        points: (n, d) points, d in (2, 3) (computed in float32).
        eps: DBSCAN radius (non-negative).
        min_pts: DBSCAN density threshold.
        mesh: a ``sharding.LocalMesh`` or ``GroupMesh``; default
            :func:`default_mesh`.
        axis: the mesh axis the points are split over.
        with_stats: also return the work statistics.
        device: where the shards live and walk; default the current CUDA
            device (``RuntimeError`` if there is none). Every walk is the
            walk kernel on a CUDA device and the plain engine on the CPU.

    Returns:
        A :class:`DBSCANResult` (``backend="sharded"``; labels and core
        identical to single-device ``dbscan``); with ``with_stats=True``,
        also a dict: ``distance_evals`` (every phase's member distance
        evaluations), ``ring_distance_evals`` (the dense ring's
        ``(2 + n_sweeps) * n_pad**2``), ``ndev``, ``n_pad``, ``n_sweeps``.

    Raises:
        ValueError: negative ``eps``; a mesh without ``axis``.
    """
    if eps < 0:
        raise ValueError(f"eps must be non-negative; got {eps}"
                         " (a negative eps would be squared away silently)")
    dev = resolve_device(device)
    points = as_points(points, dev)
    n = points.shape[0]
    if mesh is None:
        mesh = default_mesh(axis)
    ndev = _axis_or_raise(mesh, axis)
    n_pad = ((n + ndev - 1) // ndev) * ndev
    if n_pad // ndev < 2:
        # a shard-local LBVH needs >= 2 primitives; inputs this tiny take
        # the dense ring (whose cost is trivial at this scale) — stats keep
        # the normal shape, with the ring's work on both sides of the ratio
        res = ring_dbscan(points, eps, min_pts, mesh=mesh, axis=axis,
                          device=dev)
        ring_evals = (2 + res.n_sweeps) * n_pad * n_pad
        return (res, {"distance_evals": ring_evals,
                      "ring_distance_evals": ring_evals, "ndev": ndev,
                      "n_pad": n_pad,
                      "n_sweeps": res.n_sweeps}) if with_stats else res
    pts_pad, order, _ = _pad(points, ndev)
    prog = ShardedProgram(mesh, axis, n, n_pad, eps, min_pts)
    local = _slabs(mesh, axis, pts_pad, prog.n_loc)

    def add(totals, evals):
        return [t + int(e.sum(dtype=torch.int64))
                for t, e in zip(totals, evals)]

    index, core, labels, evals = prog.build(local)
    totals = add([0] * len(local), evals)
    n_sweeps = 0
    while True:
        labels, changed, evals = prog.sweep(local, index, core, labels)
        n_sweeps += 1
        totals = add(totals, evals)
        if not changed:
            break
    labels, evals = prog.border(local, index, core, labels)
    total = mesh.psum(axis, add(totals, evals))
    res = _result(mesh, axis, labels, core, order, n, n_sweeps, "sharded")
    if not with_stats:
        return res
    # ring comparator: every dense phase is a full n_pad^2 pairwise pass
    # (count + n_sweeps sweep rotations + border)
    stats = {
        "distance_evals": total,
        "ring_distance_evals": (2 + n_sweeps) * n_pad * n_pad,
        "ndev": ndev, "n_pad": n_pad, "n_sweeps": n_sweeps,
    }
    return res, stats
