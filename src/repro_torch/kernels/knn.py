"""The k-NN walk kernel: the distance-bounded rope walk with a k-best list.

``csrc/knn.cu`` computes exactly what the plain engine computes for
``traverse(tree, segs, nearest(k, r, ids, pts), KNNVisitor(k,
id_map=segs.order))``: per lane the k nearest members ascending by (d2,
original id), the member tests (``evals``) and the loop trips at a given
``unroll`` (``iters``). It replaces no Pallas kernel: the reference runs
k-NN on its XLA engine (``src/repro/core/traversal.py: traverse_impl``),
whose loop would sync the host on every trip here.

:func:`traverse` is the entry ``neighbors.knn`` calls. It dispatches on the
device of the index: CPU tensors run the plain engine; CUDA tensors launch
the kernel, which reads the index in the walk kernel's packed layout
(:mod:`repro_torch.kernels.walkpack`). It never falls back from the card to
the plain engine.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.core import traversal
from repro_torch.core.grid import Segments
from repro_torch.core.lbvh import Tree
from .traverse import PALLAS_UNROLL, _check, _check_index
from .walkpack import WalkIndex

# Threads per block (csrc/knn.cu: kBlock).
BLOCK = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_I] * 5 + [_F] + [_P] * 11


def _lib():
    lib = _build.load("knn")
    lib.knn_launch.argtypes = _ARGTYPES
    lib.knn_launch.restype = ctypes.c_int
    return lib


def walk(*, q, qid, index: WalkIndex, order, k: int, r2: float,
         unroll: int = PALLAS_UNROLL):
    """Launch the k-NN walk kernel on the current stream (CUDA tensors).

    Lane inputs: q (L, d) f32, qid (L,) i32 (-1 marks an inert lane).
    Index: ``index`` from :func:`walkpack.pack_index` over n points, m >= 2
    segments and d in {2, 3}, and ``order`` (n,) i32, the original id of
    each sorted point. ``r2`` is the squared radius cap (``inf`` for none);
    ``unroll`` only sets the trips ``iters`` reports.

    Returns (ids (L, k) i32, d2 (L, k) f32, evals (L,) i32, iters (L,) i32);
    empty slots hold (-1, +inf).

    Raises ValueError or TypeError for inputs the kernel does not take
    (checked first, so CPU tensors meet the same checks), and ValueError for
    tensors off the card.
    """
    n = index.pts.shape[0]
    d = q.shape[1] if q.dim() == 2 else -1
    L = qid.shape[0]
    m = index.leaf_end.shape[0]
    if k < 1:
        raise ValueError(f"knn: k must be >= 1, got {k}")
    if unroll < 1:
        raise ValueError(f"knn: unroll must be >= 1, got {unroll}")
    nodes_p, leaf_end_p, pts_p = _check_index(index, n, d, m)
    dev = index.pts.device
    q_p = _check(q, "q", torch.float32, (L, d), dev)
    qid_p = _check(qid, "qid", torch.int32, (L,), dev)
    order_p = _check(order, "order", torch.int32, (n,), dev)
    if dev.type != "cuda":
        raise ValueError(f"knn: the kernel needs CUDA tensors, got {dev}")
    ids = torch.empty(L, k, dtype=torch.int32, device=dev)
    d2 = torch.empty(L, k, dtype=torch.float32, device=dev)
    evals = torch.empty(L, dtype=torch.int32, device=dev)
    iters = torch.empty(L, dtype=torch.int32, device=dev)
    if L == 0:                      # nothing to launch, nothing counted
        return ids, d2, evals, iters
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().knn_launch(
        d, L, m, int(k), int(unroll), r2, q_p, qid_p, nodes_p, leaf_end_p,
        pts_p, order_p, ids.data_ptr(), d2.data_ptr(), evals.data_ptr(),
        iters.data_ptr(), stream)
    _build.check(err, "knn")
    walk.launches += 1
    return ids, d2, evals, iters


# Kernel launches (a plain integer, read by the on-card smoke run).
walk.launches = 0


def traverse(tree: Tree, segs: Segments, predicates: traversal.Nearest, *,
             unroll: int | None = None,
             walk_index: WalkIndex | None = None) -> traversal.Trace:
    """``traverse(tree, segs, predicates, KNNVisitor(k, id_map=segs.order))``
    on the device of the index.

    CPU tensors run the plain engine (``unroll`` default
    :data:`traversal.DEFAULT_UNROLL`); CUDA tensors launch the kernel
    (``unroll`` default :data:`PALLAS_UNROLL`), which reads ``walk_index``,
    the index's packed layout. The carry is a
    :class:`~repro_torch.core.traversal.KNNCarry` of original ids.

    Raises:
        TypeError: ``predicates`` is not a :func:`traversal.nearest` batch.
        NotImplementedError: on CUDA, with no tree.
        ValueError: on CUDA, no ``walk_index``, or one packed from an index
            of another size.
    """
    if not isinstance(predicates, traversal.Nearest):
        raise TypeError(f"knn.traverse takes a nearest() batch; got "
                        f"{type(predicates).__name__}")
    visitor = traversal.KNNVisitor(predicates.k, id_map=segs.order)
    if segs.pts.device.type == "cpu":
        return traversal.traverse(
            tree, segs, predicates, visitor,
            unroll=traversal.DEFAULT_UNROLL if unroll is None else unroll)
    if tree is None:
        raise NotImplementedError("the k-NN walk kernel needs a tree "
                                  "(at least two segments)")
    if walk_index is None:
        raise ValueError("the k-NN walk kernel reads the index's packed "
                         "layout: pass walk_index=walkpack.pack_index(tree, "
                         "segs)")
    if (walk_index.n_segments != segs.n_segments
            or walk_index.pts.shape[0] != segs.n_points):
        raise ValueError("knn: walk_index was packed from another index")
    query_ids, q_arr, *_, r2, _ = traversal.lane_arrays(segs, predicates)
    ids, d2, evals, iters = walk(
        q=q_arr.contiguous(), qid=query_ids.to(torch.int32).contiguous(),
        index=walk_index, order=segs.order.to(torch.int32).contiguous(),
        k=predicates.k, r2=r2,
        unroll=PALLAS_UNROLL if unroll is None else unroll)
    return traversal.Trace(carry=traversal.KNNCarry(d2=d2, ids=ids),
                           evals=evals, iters=iters)
