"""The walk kernel: the rope-based BVH walk, persistent threads with lane
refill.

``csrc/walk.cu`` is the hand-written counterpart of the Pallas kernel
``_walk_kernel`` (src/repro/kernels/traverse.py). It inlines the three
DBSCAN visitors (count, minlabel, countminlabel) into the walk and performs
``traversal.make_step``'s steps in order, so ``acc``/``hits``/``evals``
equal the plain engine's on the same inputs; it counts each lane's work
units and reports ``iters`` as the plain engine's trips at the same
``unroll``. It reads the index in the packed layout of
:mod:`repro_torch.kernels.walkpack`. Its block size is the reference's lane
tile (``lane_tile``, default :data:`LANE_TILE`).

:func:`traverse` is the single entry every clustering phase calls. It
dispatches on the device of the index: CPU tensors run the plain engine
(``repro_torch.core.traversal.traverse``); CUDA tensors launch the kernel,
or raise for a predicate or visitor the kernel does not take. It never
falls back from the card to the plain engine. With ``reorder`` it permutes
the lanes by :func:`repro_torch.core.traversal.lane_sort_key` before the
walk and puts every per-lane output back in lane order after it, on either
device (lane state never crosses lanes, so no output changes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.core import traversal
from repro_torch.obs import metrics as obs_metrics
from repro_torch.core.grid import Segments
from repro_torch.core.lbvh import Tree
from .walkpack import RECORD_WORDS, WalkIndex

INT_MAX = traversal.INT_MAX

# The work units per trip that ``iters`` is reported at by default, as the
# Pallas kernel's PALLAS_UNROLL.
PALLAS_UNROLL = 4

# The reference's default lane tile, the walk kernel's default threads per
# block; a launch takes any multiple of 32 up to 512 (csrc/walk.cu).
LANE_TILE = 128

#: Visitor types whose hooks the kernel inlines, by kernel kind code.
KINDS = {traversal.CountVisitor: 0, traversal.MinLabelVisitor: 1,
         traversal.CountMinLabelVisitor: 2}
#: Visitor types whose hooks the kernel inlines (the reference's name).
FUSIBLE_VISITORS = tuple(KINDS)
#: the kinds' names in the launch counters (the reference's labels)
KIND_NAMES = ("count", "minlabel", "countminlabel")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I] * 11 + [_F, _I] + [_P] * 25


def fusible(predicates, callback) -> bool:
    """Can this (predicate, callback) pair run as the walk kernel?"""
    return (isinstance(predicates, traversal.Intersects)
            and type(callback) in KINDS)


def _lib():
    lib = _build.load("walk")
    lib.walk_launch.argtypes = _ARGTYPES
    lib.walk_launch.restype = ctypes.c_int
    return lib


def _check(x, name, dtype, shape, dev=None, align=4):
    if x.dtype != dtype:
        raise TypeError(f"walk: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"walk: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"walk: {name} is not contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"walk: {name} is not aligned to {align} bytes")
    if dev is not None and x.device != dev:
        raise ValueError(f"walk: {name} is on {x.device}, expected {dev}")
    return x.data_ptr()


def _check_index(index: WalkIndex, n: int, d: int, m: int, dev=None):
    """Pointers of the packed index after checking its shapes, dtypes,
    contiguity and the alignment of its vector loads."""
    if d not in (2, 3):
        raise ValueError(f"walk: d must be 2 or 3, got {d}")
    if m < 2:
        raise ValueError("walk: the index needs at least two segments")
    width = 4 if d == 3 else 2
    return (_check(index.nodes, "nodes", torch.int32,
                   (2 * m - 1, RECORD_WORDS), dev, align=16),
            _check(index.leaf_end, "leaf_end", torch.int32, (m,), dev),
            _check(index.pts, "pts", torch.float32, (n, width), dev,
                   align=4 * width))


def walk(kind: int, *, q, qid, self_id, dense, rank, wide, acc0, hits0,
         index: WalkIndex, r2: float, cap: int = INT_MAX,
         unroll: int = PALLAS_UNROLL, block: int = LANE_TILE, range_r=None,
         node_mask=None, node_mask_wide=None, vals=None, mask=None,
         mask_wide=None, root=None):
    """Launch the walk kernel on the current stream (CUDA tensors only).

    Lane inputs: q (L, d) f32; qid, self_id, rank (L,) i32; dense, wide (L,)
    bool; acc0 (L,) i32 (f32 with float ``vals``); hits0 (L,) i32; root
    (L,) i32, each lane's start node (optional; default node 0).
    ``block``: threads a block, a multiple of 32 from 32 to 512 (no output
    depends on it). Index:
    ``index`` from :func:`walkpack.pack_index` over n points, m >= 2
    segments and d in {2, 3}; optional range_r (2m-1,) i32 (turns the range
    mask on), node_mask and node_mask_wide (2m-1,) bool; vals (n,) i32 or
    f32, mask, mask_wide (n,) bool for the minlabel kinds. ``unroll`` only
    sets the trips ``iters`` reports.

    Returns (acc, hits, evals, iters), each (L,).

    Raises ValueError or TypeError for inputs the kernel does not take
    (checked first, so CPU tensors meet the same checks), and ValueError for
    tensors off the card.
    """
    if kind not in (0, 1, 2):
        raise ValueError(f"walk: unknown visitor kind {kind}")
    n = index.pts.shape[0]
    d = q.shape[1] if q.dim() == 2 else -1
    L = qid.shape[0]
    m = index.leaf_end.shape[0]
    if unroll < 1:
        raise ValueError(f"walk: unroll must be >= 1, got {unroll}")
    if block < 32 or block > 512 or block % 32:
        raise ValueError(f"walk: block must be a multiple of 32 from 32 to "
                         f"512, got {block}")
    nodes_p, leaf_end_p, pts_p = _check_index(index, n, d, m)
    dev = index.pts.device
    nn = 2 * m - 1
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    vals_dtype = i32 if kind == 0 else vals.dtype
    if vals_dtype not in (i32, f32):
        raise TypeError(f"walk: vals must be int32 or float32, got "
                        f"{vals_dtype}")
    has_mask_wide = mask_wide is not None
    if has_mask_wide and kind != 1:
        raise ValueError("walk: mask_wide needs the minlabel kind")
    if node_mask_wide is not None and node_mask is None:
        raise ValueError("walk: node_mask_wide needs node_mask")
    p = dict(
        q=_check(q, "q", f32, (L, d), dev),
        qid=_check(qid, "qid", i32, (L,), dev),
        root=None if root is None else _check(root, "root", i32, (L,), dev),
        self_id=_check(self_id, "self_id", i32, (L,), dev),
        dense=_check(dense, "dense", b8, (L,), dev, align=1),
        rank=_check(rank, "rank", i32, (L,), dev),
        wide=_check(wide, "wide", b8, (L,), dev, align=1),
        acc0=_check(acc0, "acc0", vals_dtype, (L,), dev),
        hits0=_check(hits0, "hits0", i32, (L,), dev),
        range_r=(None if range_r is None
                 else _check(range_r, "range_r", i32, (nn,), dev)),
        node_mask=(None if node_mask is None
                   else _check(node_mask, "node_mask", b8, (nn,), dev,
                               align=1)),
        node_mask_wide=(None if node_mask_wide is None
                        else _check(node_mask_wide, "node_mask_wide", b8,
                                    (nn,), dev, align=1)),
        vals=None if kind == 0 else _check(vals, "vals", vals_dtype, (n,),
                                           dev),
        mask=(None if kind == 0
              else _check(mask, "mask", b8, (n,), dev, align=1)),
        mask_wide=(None if not has_mask_wide
                   else _check(mask_wide, "mask_wide", b8, (n,), dev,
                               align=1)),
    )
    if dev.type != "cuda":
        raise ValueError(f"walk: the kernel needs CUDA tensors, got {dev}")
    acc = torch.empty(L, dtype=vals_dtype, device=dev)
    hits = torch.empty(L, dtype=i32, device=dev)
    evals = torch.empty(L, dtype=i32, device=dev)
    iters = torch.empty(L, dtype=i32, device=dev)
    if L == 0:                      # nothing to launch, nothing counted
        return acc, hits, evals, iters
    nxt = torch.empty(1, dtype=i32, device=dev)    # zeroed by walk_launch
    grid = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().walk_launch(
        kind, int(vals_dtype == f32), d, int(block), int(unroll),
        int(range_r is not None),
        int(node_mask is not None), int(node_mask_wide is not None),
        int(has_mask_wide), L, m, r2, int(cap),
        p["q"], p["qid"], p["root"], p["self_id"], p["dense"], p["rank"],
        p["wide"],
        p["acc0"], p["hits0"], nodes_p, leaf_end_p, pts_p, p["vals"],
        p["mask"], p["mask_wide"], p["range_r"], p["node_mask"],
        p["node_mask_wide"], nxt.data_ptr(),
        acc.data_ptr(), hits.data_ptr(), evals.data_ptr(), iters.data_ptr(),
        stream, ctypes.addressof(grid))
    _build.check(err, "walk")
    walk.launches += 1
    walk.last_grid = grid.value
    walk.last_block = int(block)
    # the reference's launch counter, under its name
    obs_metrics.inc("pallas_kernel_launches_total", kind=KIND_NAMES[kind])
    return acc, hits, evals, iters


# Kernel launches (a plain integer, read by the on-card smoke run), and the
# grid (blocks) and block (threads) of the latest launch.
walk.launches = 0
walk.last_grid = 0
walk.last_block = 0




def _permute_trace(tr: traversal.Trace, inv) -> traversal.Trace:
    """A trace's per-lane outputs taken back through ``inv``."""
    return traversal.Trace(
        carry=traversal.tree_map(lambda x: x[inv], tr.carry),
        evals=tr.evals[inv], iters=tr.iters[inv])


def traverse(tree: Tree, segs: Segments, predicates, callback, carry=None,
             node_mask=None, node_mask_wide=None, wide_lanes=None,
             use_range_mask: bool = False, unroll: int | None = None,
             lane_tile: int = LANE_TILE, reorder: str = "none",
             depth_rank=None,
             walk_index: WalkIndex | None = None,
             root=None) -> traversal.Trace:
    """The walk, on the device of the index.

    CPU tensors run the plain engine (``unroll`` default
    :data:`traversal.DEFAULT_UNROLL`); CUDA tensors launch the walk kernel
    (``unroll`` default :data:`PALLAS_UNROLL`). Arguments as in
    :func:`repro_torch.core.traversal.traverse`, plus:

    lane_tile: the kernel's threads per block (a multiple of 32 from 32 to
        512); the plain engine has no blocks and ignores it.
    reorder / depth_rank: the lane order, as the reference's Pallas walk
        takes them — ``"none"``, ``"morton"`` or ``"depth"`` by
        :func:`repro_torch.core.traversal.lane_sort_key`. The lanes are
        permuted by a stable sort of the key before the walk (on either
        device) and every per-lane output is put back in lane order after
        it, so no output depends on the policy. Ignored, as by the
        reference, where its walk falls back to its engine (no tree, or a
        predicate or visitor the kernel does not take).
    walk_index: the index's packed layout (:func:`walkpack.pack_index`,
        built once per index), which the kernel reads and the plain engine
        does not.
    root: optional (lanes,) int32 start node a lane, for a forest of
        trees packed into one index (see
        :func:`repro_torch.core.traversal.traverse`).

    Raises:
        NotImplementedError: on CUDA, for a predicate or visitor the kernel
            does not inline (only ``intersects`` with the three DBSCAN
            visitors), or with no tree.
        ValueError: an unknown ``reorder``; on CUDA, no ``walk_index``, one
            packed from an index of another size, or a ``lane_tile`` the
            kernel does not take.
    """
    plain_unroll = traversal.DEFAULT_UNROLL if unroll is None else unroll
    cpu = segs.pts.device.type == "cpu"
    if cpu and (tree is None or segs.n_segments < 2
                or not fusible(predicates, callback)):
        return traversal.traverse(
            tree, segs, predicates, callback, carry=carry,
            node_mask=node_mask, node_mask_wide=node_mask_wide,
            wide_lanes=wide_lanes, use_range_mask=use_range_mask,
            unroll=plain_unroll, root=root)
    if not cpu:
        if not fusible(predicates, callback):
            raise NotImplementedError(
                f"the walk kernel takes intersects() with CountVisitor, "
                f"MinLabelVisitor or CountMinLabelVisitor; got "
                f"{type(predicates).__name__} with "
                f"{type(callback).__name__}")
        if tree is None:
            raise NotImplementedError("the walk kernel needs a tree "
                                      "(at least two segments)")
        if walk_index is None:
            raise ValueError("the walk kernel reads the index's packed "
                             "layout: pass walk_index=walkpack.pack_index("
                             "tree, segs)")
        if (walk_index.n_segments != segs.n_segments
                or walk_index.pts.shape[0] != segs.n_points):
            raise ValueError("walk: walk_index was packed from another "
                             "index")
    (query_ids, q_arr, self_arr, dense_arr, rank_arr, external, r2,
     _) = traversal.lane_arrays(segs, predicates, use_range_mask)
    key = traversal.lane_sort_key(reorder, query_ids, q_arr, external,
                                  depth_rank)
    perm = inv = None
    if key is not None:
        # equal keys keep lane order (a stable sort, as the reference's);
        # the inverse is a scatter, not a second sort
        perm = torch.argsort(key, stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    if cpu:
        if perm is None:
            return traversal.traverse(
                tree, segs, predicates, callback, carry=carry,
                node_mask=node_mask, node_mask_wide=node_mask_wide,
                wide_lanes=wide_lanes, use_range_mask=use_range_mask,
                unroll=plain_unroll, root=root)
        # the plain engine walks the permuted batch: ids and external
        # points, the carry and the wide lanes in the new order
        pred = traversal.Intersects(predicates.geometry, ids=query_ids[perm],
                                    pts=q_arr[perm] if external else None)
        tr = traversal.traverse(
            tree, segs, pred, callback,
            carry=(None if carry is None
                   else traversal.tree_map(lambda x: x[perm], carry)),
            node_mask=node_mask, node_mask_wide=node_mask_wide,
            wide_lanes=None if wide_lanes is None else wide_lanes[perm],
            use_range_mask=use_range_mask, unroll=plain_unroll,
            root=None if root is None else root[perm])
        return _permute_trace(tr, inv)
    if carry is None:
        carry = callback.init_carry(query_ids, external, segs)
    if wide_lanes is None:
        wide_lanes = torch.zeros_like(query_ids, dtype=torch.bool)
    lanes = (q_arr, query_ids, self_arr, dense_arr, rank_arr, wide_lanes,
             carry.acc, carry.hits)
    if root is not None:
        lanes += (root,)
    if perm is not None:
        lanes = tuple(x[perm] for x in lanes)
    q_arr, query_ids, self_arr, dense_arr, rank_arr, wide_lanes, acc0, \
        hits0 = (x.contiguous() for x in lanes[:8])
    if root is not None:
        root = lanes[8].contiguous()
    kind = KINDS[type(callback)]
    acc, hits, evals, iters = walk(
        kind, q=q_arr, qid=query_ids, self_id=self_arr, dense=dense_arr,
        rank=rank_arr, wide=wide_lanes, acc0=acc0, hits0=hits0,
        index=walk_index, r2=r2,
        cap=getattr(callback, "cap", INT_MAX),
        unroll=PALLAS_UNROLL if unroll is None else unroll,
        block=int(lane_tile),
        range_r=tree.range_r if use_range_mask else None,
        node_mask=node_mask,
        node_mask_wide=node_mask_wide if node_mask is not None else None,
        vals=getattr(callback, "vals", None),
        mask=getattr(callback, "mask", None),
        mask_wide=(callback.mask_wide if kind == 1 else None),
        root=root)
    tr = traversal.Trace(carry=traversal.AccHits(acc=acc, hits=hits),
                         evals=evals, iters=iters)
    return tr if inv is None else _permute_trace(tr, inv)
