"""The walk kernel: the rope-based BVH walk, persistent threads with lane
refill.

``csrc/walk.cu`` is the hand-written counterpart of the Pallas kernel
``_walk_kernel`` (src/repro/kernels/traverse.py). It inlines the three
DBSCAN visitors (count, minlabel, countminlabel) into the walk and performs
``traversal.make_step``'s steps in order, so ``acc``/``hits``/``evals``
equal the plain engine's on the same inputs; it counts each lane's work
units and reports ``iters`` as the plain engine's trips at the same
``unroll``. It reads the index in the packed layout of
:mod:`repro_torch.kernels.walkpack`.

:func:`traverse` is the single entry every clustering phase calls. It
dispatches on the device of the index: CPU tensors run the plain engine
(``repro_torch.core.traversal.traverse``); CUDA tensors launch the kernel,
or raise for a predicate or visitor the kernel does not take. It never
falls back from the card to the plain engine.
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

# Threads per block of the walk kernel (csrc/walk.cu: kBlock).
BLOCK = 128

#: Visitor types whose hooks the kernel inlines, by kernel kind code.
KINDS = {traversal.CountVisitor: 0, traversal.MinLabelVisitor: 1,
         traversal.CountMinLabelVisitor: 2}
#: the kinds' names in the launch counters (the reference's labels)
KIND_NAMES = ("count", "minlabel", "countminlabel")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I] * 10 + [_F, _I] + [_P] * 24


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
         unroll: int = PALLAS_UNROLL, range_r=None, node_mask=None,
         node_mask_wide=None, vals=None, mask=None, mask_wide=None):
    """Launch the walk kernel on the current stream (CUDA tensors only).

    Lane inputs: q (L, d) f32; qid, self_id, rank (L,) i32; dense, wide (L,)
    bool; acc0 (L,) i32 (f32 with float ``vals``); hits0 (L,) i32. Index:
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
        kind, int(vals_dtype == f32), d, int(unroll), int(range_r is not None),
        int(node_mask is not None), int(node_mask_wide is not None),
        int(has_mask_wide), L, m, r2, int(cap),
        p["q"], p["qid"], p["self_id"], p["dense"], p["rank"], p["wide"],
        p["acc0"], p["hits0"], nodes_p, leaf_end_p, pts_p, p["vals"],
        p["mask"], p["mask_wide"], p["range_r"], p["node_mask"],
        p["node_mask_wide"], nxt.data_ptr(),
        acc.data_ptr(), hits.data_ptr(), evals.data_ptr(), iters.data_ptr(),
        stream, ctypes.addressof(grid))
    _build.check(err, "walk")
    walk.launches += 1
    walk.last_grid = grid.value
    if obs_metrics.active() is not None:
        # the reference's launch counters, under its names
        obs_metrics.inc("pallas_kernel_launches_total", kind=KIND_NAMES[kind])
        obs_metrics.inc("pallas_kernel_lanes_total", float(L),
                        kind=KIND_NAMES[kind])
    return acc, hits, evals, iters


# Kernel launches (a plain integer, read by the on-card smoke run), and the
# grid of the latest launch (blocks).
walk.launches = 0
walk.last_grid = 0


def traverse(tree: Tree, segs: Segments, predicates, callback, carry=None,
             node_mask=None, node_mask_wide=None, wide_lanes=None,
             use_range_mask: bool = False, unroll: int | None = None,
             walk_index: WalkIndex | None = None) -> traversal.Trace:
    """The walk, on the device of the index.

    CPU tensors run the plain engine (``unroll`` default
    :data:`traversal.DEFAULT_UNROLL`); CUDA tensors launch the walk kernel
    (``unroll`` default :data:`PALLAS_UNROLL`). Arguments as in
    :func:`repro_torch.core.traversal.traverse`, plus ``walk_index``: the
    index's packed layout (:func:`walkpack.pack_index`, built once per
    index), which the kernel reads and the plain engine does not.

    Raises:
        NotImplementedError: on CUDA, for a predicate or visitor the kernel
            does not inline (only ``intersects`` with the three DBSCAN
            visitors), or with no tree.
        ValueError: on CUDA, no ``walk_index``, or one packed from an index
            of another size.
    """
    if segs.pts.device.type == "cpu":
        return traversal.traverse(
            tree, segs, predicates, callback, carry=carry,
            node_mask=node_mask, node_mask_wide=node_mask_wide,
            wide_lanes=wide_lanes, use_range_mask=use_range_mask,
            unroll=traversal.DEFAULT_UNROLL if unroll is None else unroll)
    if not fusible(predicates, callback):
        raise NotImplementedError(
            f"the walk kernel takes intersects() with CountVisitor, "
            f"MinLabelVisitor or CountMinLabelVisitor; got "
            f"{type(predicates).__name__} with {type(callback).__name__}")
    if tree is None:
        raise NotImplementedError("the walk kernel needs a tree "
                                  "(at least two segments)")
    if walk_index is None:
        raise ValueError("the walk kernel reads the index's packed layout: "
                         "pass walk_index=walkpack.pack_index(tree, segs)")
    if (walk_index.n_segments != segs.n_segments
            or walk_index.pts.shape[0] != segs.n_points):
        raise ValueError("walk: walk_index was packed from another index")
    (query_ids, q_arr, self_arr, dense_arr, rank_arr, external, r2,
     _) = traversal.lane_arrays(segs, predicates, use_range_mask)
    if carry is None:
        carry = callback.init_carry(query_ids, external, segs)
    if wide_lanes is None:
        wide_lanes = torch.zeros_like(query_ids, dtype=torch.bool)
    kind = KINDS[type(callback)]
    acc, hits, evals, iters = walk(
        kind, q=q_arr.contiguous(), qid=query_ids.contiguous(),
        self_id=self_arr.contiguous(), dense=dense_arr.contiguous(),
        rank=rank_arr.contiguous(), wide=wide_lanes.contiguous(),
        acc0=carry.acc.contiguous(), hits0=carry.hits.contiguous(),
        index=walk_index, r2=r2,
        cap=getattr(callback, "cap", INT_MAX),
        unroll=PALLAS_UNROLL if unroll is None else unroll,
        range_r=tree.range_r if use_range_mask else None,
        node_mask=node_mask,
        node_mask_wide=node_mask_wide if node_mask is not None else None,
        vals=getattr(callback, "vals", None),
        mask=getattr(callback, "mask", None),
        mask_wide=(callback.mask_wide if kind == 1 else None))
    return traversal.Trace(carry=traversal.AccHits(acc=acc, hits=hits),
                           evals=evals, iters=iters)
