"""The walk kernel: the rope-based BVH walk, one CUDA thread per query.

``csrc/walk.cu`` is the hand-written counterpart of the Pallas kernel
``_walk_kernel`` (src/repro/kernels/traverse.py). It inlines the three
DBSCAN visitors (count, minlabel, countminlabel) into the walk and performs
``traversal.make_step`` step for step, so ``acc``/``hits``/``evals`` equal
the plain engine's on the same inputs and ``iters`` equals it at the same
``unroll``.

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
from repro_torch.core.grid import Segments
from repro_torch.core.lbvh import Tree

INT_MAX = traversal.INT_MAX

# Work units per loop trip of the kernel, as the Pallas kernel's
# PALLAS_UNROLL: each trip's bookkeeping (the liveness test, the trip
# counter) is paid once per 4 units.
PALLAS_UNROLL = 4

#: Visitor types whose hooks the kernel inlines, by kernel kind code.
KINDS = {traversal.CountVisitor: 0, traversal.MinLabelVisitor: 1,
         traversal.CountMinLabelVisitor: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_I] * 10 + [_F, _I] + [_P] * 27)


def fusible(predicates, callback) -> bool:
    """Can this (predicate, callback) pair run as the walk kernel?"""
    return (isinstance(predicates, traversal.Intersects)
            and type(callback) in KINDS)


def _lib():
    lib = _build.load("walk")
    lib.walk_launch.argtypes = _ARGTYPES
    lib.walk_launch.restype = ctypes.c_int
    return lib


def _check(x, name, dtype, shape, dev):
    if x.device != dev:
        raise ValueError(f"walk: {name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"walk: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"walk: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"walk: {name} is not contiguous")
    return x.data_ptr()


def walk(kind: int, *, q, qid, self_id, dense, rank, wide, acc0, hits0,
         pts, seg_start, seg_end, dense_seg, left, miss, box_lo, box_hi,
         r2: float, cap: int = INT_MAX, unroll: int = PALLAS_UNROLL,
         range_r=None, node_mask=None, node_mask_wide=None, vals=None,
         mask=None, mask_wide=None):
    """Launch the walk kernel on the current stream (CUDA tensors only).

    Lane inputs: q (L, d) f32; qid, self_id, rank (L,) i32; dense, wide (L,)
    bool; acc0 (L,) i32 (f32 with float ``vals``); hits0 (L,) i32. Index:
    pts (n, d) f32; seg_start, seg_end (m,) i32; dense_seg (m,) bool; left
    (m-1,) i32; miss (2m-1,) i32; box_lo, box_hi (2m-1, d) f32; optional
    range_r (2m-1,) i32 (turns the range mask on), node_mask and
    node_mask_wide (2m-1,) bool; vals (n,) i32 or f32, mask, mask_wide
    (n,) bool for the minlabel kinds. d in {2, 3}, m >= 2.

    Returns (acc, hits, evals, iters), each (L,).
    """
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"walk: the kernel needs CUDA tensors, got {dev}")
    if kind not in (0, 1, 2):
        raise ValueError(f"walk: unknown visitor kind {kind}")
    n, d = pts.shape
    L = qid.shape[0]
    m = seg_start.shape[0]
    if d not in (2, 3):
        raise ValueError(f"walk: d must be 2 or 3, got {d}")
    if m < 2:
        raise ValueError("walk: the index needs at least two segments")
    if unroll < 1:
        raise ValueError(f"walk: unroll must be >= 1, got {unroll}")
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
        dense=_check(dense, "dense", b8, (L,), dev),
        rank=_check(rank, "rank", i32, (L,), dev),
        wide=_check(wide, "wide", b8, (L,), dev),
        acc0=_check(acc0, "acc0", vals_dtype, (L,), dev),
        hits0=_check(hits0, "hits0", i32, (L,), dev),
        pts=_check(pts, "pts", f32, (n, d), dev),
        seg_start=_check(seg_start, "seg_start", i32, (m,), dev),
        seg_end=_check(seg_end, "seg_end", i32, (m,), dev),
        dense_seg=_check(dense_seg, "dense_seg", b8, (m,), dev),
        left=_check(left, "left", i32, (m - 1,), dev),
        miss=_check(miss, "miss", i32, (nn,), dev),
        range_r=(None if range_r is None
                 else _check(range_r, "range_r", i32, (nn,), dev)),
        box_lo=_check(box_lo, "box_lo", f32, (nn, d), dev),
        box_hi=_check(box_hi, "box_hi", f32, (nn, d), dev),
        node_mask=(None if node_mask is None
                   else _check(node_mask, "node_mask", b8, (nn,), dev)),
        node_mask_wide=(None if node_mask_wide is None
                        else _check(node_mask_wide, "node_mask_wide", b8,
                                    (nn,), dev)),
        vals=None if kind == 0 else _check(vals, "vals", vals_dtype, (n,),
                                           dev),
        mask=None if kind == 0 else _check(mask, "mask", b8, (n,), dev),
        mask_wide=(None if not has_mask_wide
                   else _check(mask_wide, "mask_wide", b8, (n,), dev)),
    )
    acc = torch.empty(L, dtype=vals_dtype, device=dev)
    hits = torch.empty(L, dtype=i32, device=dev)
    evals = torch.empty(L, dtype=i32, device=dev)
    iters = torch.empty(L, dtype=i32, device=dev)
    if L == 0:                      # nothing to launch, nothing counted
        return acc, hits, evals, iters
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().walk_launch(
        kind, int(vals_dtype == f32), d, int(unroll), int(range_r is not None),
        int(node_mask is not None), int(node_mask_wide is not None),
        int(has_mask_wide), L, m, r2, int(cap),
        p["q"], p["qid"], p["self_id"], p["dense"], p["rank"], p["wide"],
        p["acc0"], p["hits0"], p["pts"], p["seg_start"], p["seg_end"],
        p["dense_seg"], p["left"], p["miss"], p["range_r"], p["box_lo"],
        p["box_hi"], p["node_mask"], p["node_mask_wide"], p["vals"],
        p["mask"], p["mask_wide"], acc.data_ptr(), hits.data_ptr(),
        evals.data_ptr(), iters.data_ptr(), stream)
    _build.check(err, "walk")
    walk.launches += 1
    return acc, hits, evals, iters


# Kernel launches (a plain integer, read by the on-card smoke run).
walk.launches = 0


def traverse(tree: Tree, segs: Segments, predicates, callback, carry=None,
             node_mask=None, node_mask_wide=None, wide_lanes=None,
             use_range_mask: bool = False,
             unroll: int | None = None) -> traversal.Trace:
    """The walk, on the device of the index.

    CPU tensors run the plain engine (``unroll`` default
    :data:`traversal.DEFAULT_UNROLL`); CUDA tensors launch the walk kernel
    (``unroll`` default :data:`PALLAS_UNROLL`). Arguments as in
    :func:`repro_torch.core.traversal.traverse`.

    Raises:
        NotImplementedError: on CUDA, for a predicate or visitor the kernel
            does not inline (only ``intersects`` with the three DBSCAN
            visitors), or with no tree.
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
    (query_ids, q_arr, self_arr, dense_arr, rank_arr, external,
     r2) = traversal.lane_arrays(segs, predicates, use_range_mask)
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
        pts=segs.pts, seg_start=segs.seg_start, seg_end=segs.seg_end,
        dense_seg=segs.dense_seg, left=tree.left, miss=tree.miss,
        box_lo=tree.box_lo, box_hi=tree.box_hi, r2=r2,
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
