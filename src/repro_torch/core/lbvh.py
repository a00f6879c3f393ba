"""Linear bounding volume hierarchy (Karras 2012) over tensors.

The paper uses ArborX's LBVH as the search index because of its fast fully
parallel construction and low-divergence batched traversal. The same
construction here:

  * primitives are sorted by Morton code (``repro_torch.core.morton``),
  * every internal node's primitive range / split is found independently
    with binary searches over the common-prefix-length function ``delta``,
    written out over the whole vector of internal nodes at once,
  * bounding boxes are fitted bottom-up with level-synchronous bulk sweeps
    (a node becomes ready once both children are ready), which keeps the
    fit deterministic and needs no atomics; the host reads one flag a
    level (``host_syncs_total{site="lbvh.fit_boxes"}``),
  * traversal is stackless: *ropes* (miss links = next node in DFS order
    when a subtree is skipped) give every query O(1) walk state.

Node numbering: internal nodes are ``0 .. n-2`` (root = 0), leaf ``k`` is node
``(n-1) + k``. ``n`` is the number of *primitives* (segments).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.obs import syncs

# Enough doublings/halvings to cover any practical primitive count (2**30).
_SEARCH_ITERS = 31


def fma_f32(a, b, c):
    """Correctly rounded float32 ``a * b + c`` (one rounding), on any device.

    The product of two float32 values is exact in float64; the sum is
    rounded to float64 with round-to-odd (the exact error of the float64
    addition decides the last bit), and rounding that to float32 is then
    the single correctly rounded result — what a fused multiply-add
    instruction gives.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)            # exact: p + cd == s + err
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)                 # err points away from zero
    bits = torch.where(nudge, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).float()


def sum_sq(x):
    """Sum of squares over the last axis, rounded as the reference's
    compiled float32 code rounds it: ``x0*x0``, then one fused
    multiply-add per further axis, in axis order. (The reference writes
    ``jnp.sum(x * x, -1)``; XLA's CPU code contracts it into this chain, as
    it computes every dot product; the walk kernel writes the chain out
    with ``__fmaf_rn``.)"""
    out = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        out = fma_f32(x[..., k], x[..., k], out)
    return out


def box_dist2(q, lo, hi):
    """Squared distance from point ``q`` to the AABB ``[lo, hi]`` (0 inside),
    in the reference's op order (lbvh.py: max(max(lo - q, q - hi), 0), then
    the sum of squares)."""
    return sum_sq(torch.clamp_min(torch.maximum(lo - q, q - hi), 0.0))


class Tree(NamedTuple):
    """Flat LBVH arrays. Internal nodes first, then leaves.

    All index arrays are int32 over node ids in [0, 2n-1); -1 is the
    "no node" sentinel (end of traversal).
    """
    left: torch.Tensor      # (n-1,) left child node id of internal node i
    right: torch.Tensor     # (n-1,) right child node id
    parent: torch.Tensor    # (2n-1,) parent node id (-1 for root)
    miss: torch.Tensor      # (2n-1,) rope: node to visit when skipping it
    range_r: torch.Tensor   # (2n-1,) max leaf (primitive) index below it
    box_lo: torch.Tensor    # (2n-1, d) AABB lower corners
    box_hi: torch.Tensor    # (2n-1, d) AABB upper corners

    @property
    def n_leaves(self) -> int:
        return (self.parent.shape[0] + 1) // 2

    def leaf_id(self, k):
        return k + self.n_leaves - 1


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count of leading zeros of the 32-bit value held in int64 ``x``
    (32 for 0), as ``lax.clz`` on uint32."""
    bl = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        c = t > 0
        x = torch.where(c, t, x)
        bl = bl + torch.where(c, s, 0)
    bl = bl + (x > 0).to(x.dtype)
    return 32 - bl


def _delta_fn(codes: torch.Tensor):
    """Common-prefix length between sorted codes i and j, with the standard
    Karras index tie-break (equal codes -> 32 + clz(i ^ j)); -1 outside."""
    n = codes.shape[0]

    def delta(i, j):
        oob = (j < 0) | (j >= n)
        j_safe = torch.clamp(j, 0, n - 1)
        x = codes[i] ^ codes[j_safe]
        tie = 32 + _clz32(i ^ j_safe)
        d = torch.where(x == 0, tie, _clz32(x))
        return torch.where(oob, -1, d)

    return delta


def _build_topology(codes: torch.Tensor):
    """Karras internal-node construction over all internal nodes at once.

    Returns int32 (left, right, first, last): children node ids and the
    primitive index range [first, last] covered by each internal node.
    Index arithmetic runs in int64 (no overflow); every value fits int32.
    """
    n = codes.shape[0]
    delta = _delta_fn(codes)
    i = torch.arange(n - 1, dtype=torch.int64, device=codes.device)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    delta_min = delta(i, i - d)

    # Exponential search for an upper bound on the range length. For
    # sorted codes delta is non-increasing away from i, so the masked
    # doubling below is monotone (once the test fails it stays false).
    l_max = torch.full_like(i, 2)
    for _ in range(_SEARCH_ITERS):
        grow = delta(i, i + l_max * d) > delta_min
        l_max = torch.where(grow, l_max * 2, l_max)

    # Binary search for the exact length; l_max is a power of two, so the
    # halving sequence visits each power exactly once (t==0 is inert).
    l = torch.zeros_like(i)
    t = l_max
    for _ in range(_SEARCH_ITERS):
        t = t // 2
        ok = (t > 0) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(ok, l + t, l)
    j = i + l * d  # other end of the range

    # Split search (ceil-halving with a done flag so t==1 fires once).
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = l
    done = torch.zeros_like(i, dtype=torch.bool)
    for _ in range(_SEARCH_ITERS):
        t = (t + 1) // 2
        ok = ~done & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(ok, s + t, s)
        done = done | (t <= 1)
    gamma = i + s * d + torch.clamp_max(d, 0)

    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    leaf_off = n - 1
    left = torch.where(first == gamma, gamma + leaf_off, gamma)
    right = torch.where(last == gamma + 1, gamma + 1 + leaf_off, gamma + 1)
    return tuple(x.to(torch.int32) for x in (left, right, first, last))


def _fit_boxes(left, right, prim_lo, prim_hi):
    """Level-synchronous bottom-up AABB fit (no atomics)."""
    n = prim_lo.shape[0]
    n_int = n - 1
    d = prim_lo.shape[1]
    dev = prim_lo.device
    box_lo = torch.cat([torch.full((n_int, d), float("inf"),
                                   dtype=prim_lo.dtype, device=dev), prim_lo])
    box_hi = torch.cat([torch.full((n_int, d), float("-inf"),
                                   dtype=prim_hi.dtype, device=dev), prim_hi])
    ready = torch.cat([torch.zeros(n_int, dtype=torch.bool, device=dev),
                       torch.ones(n, dtype=torch.bool, device=dev)])
    while not syncs.read(ready[0], "lbvh.fit_boxes"):
        can = ready[left] & ready[right] & ~ready[:n_int]
        new_lo = torch.minimum(box_lo[left], box_lo[right])
        new_hi = torch.maximum(box_hi[left], box_hi[right])
        box_lo[:n_int] = torch.where(can[:, None], new_lo, box_lo[:n_int])
        box_hi[:n_int] = torch.where(can[:, None], new_hi, box_hi[:n_int])
        ready[:n_int] |= can
    return box_lo, box_hi


def _compute_ropes(left, right, parent, n_nodes):
    """miss[v] = right sibling if v is a left child, else miss[parent].

    Resolved with bulk sweeps (value propagates one tree level per sweep).
    """
    dev = left.device
    # constants are written with fill_ (a kernel argument): an item
    # assignment copies its scalar from host memory and waits
    is_left = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
    is_left.index_fill_(0, left.long(), True)
    sibling = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)
    sibling[left] = right
    miss = torch.where(is_left, sibling, -1).to(torch.int32)
    miss[:1].fill_(-1)  # root: end of traversal
    done = is_left.clone()
    done[:1].fill_(True)
    par = torch.clamp_min(parent, 0)
    while not syncs.read(done.all(), "lbvh.ropes"):
        miss = torch.where(done, miss, miss[par])
        miss[:1].fill_(-1)
        done = done | done[par]
        done[:1].fill_(True)
    return miss


def propagate_leaf_flags(tree: Tree, flags: torch.Tensor,
                         item_leaf: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """(2n-1,) per-node OR of ``flags`` over each subtree's leaves.

    ``flags`` holds one flag a leaf, or, with ``item_leaf`` (int32, the
    leaf of each item: ``Segments.seg_of_point``), one an item. Frontier
    sweeps use this to mark subtrees containing changed points so the
    traversal can prune unchanged regions. CUDA tensors take the node-flag
    kernel (``kernels.nodeflags``: one launch, no host read); CPU tensors
    the reference's loop, :func:`propagate_leaf_flags_by_level`. Both give
    the same bytes.
    """
    if flags.is_cuda:
        from repro_torch.kernels.nodeflags import node_flags
        return node_flags(tree.parent, flags, item_leaf)
    return propagate_leaf_flags_by_level(tree, flags, item_leaf)


def propagate_leaf_flags_by_level(tree: Tree, flags: torch.Tensor,
                                  item_leaf: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """:func:`propagate_leaf_flags` as the reference computes it, on any
    device: the items' flags folded onto their leaves by a segment
    maximum, then level-synchronous bottom-up sweeps like ``_fit_boxes``
    (no atomics; the host reads one flag a sweep)."""
    n_int = tree.left.shape[0]
    if item_leaf is not None:
        # every leaf holds an item, so no leaf keeps the empty fill
        flags = torch.empty(n_int + 1, dtype=torch.int32,
                            device=flags.device).scatter_reduce_(
            0, item_leaf.long(), flags.to(torch.int32), "amax",
            include_self=False).to(torch.bool)
    flags = torch.cat([torch.zeros(n_int, dtype=torch.bool,
                                   device=flags.device), flags])
    while True:
        new_int = flags[tree.left] | flags[tree.right]
        if syncs.read((new_int == flags[:n_int]).all(), "lbvh.leaf_flags"):
            return flags
        flags = torch.cat([new_int, flags[n_int:]])


def build_tree(codes: torch.Tensor, prim_lo: torch.Tensor,
               prim_hi: torch.Tensor) -> Tree:
    """Build the LBVH over primitives sorted by ``codes``.

    ``prim_lo``/``prim_hi`` are (n, d) AABB corners of the (sorted)
    primitives. n must be >= 2 (callers special-case n < 2).
    """
    n = codes.shape[0]
    dev = codes.device
    left, right, first, last = _build_topology(codes)
    n_nodes = 2 * n - 1

    ar = torch.arange(n - 1, dtype=torch.int32, device=dev)
    parent = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)
    parent[left] = ar
    parent[right] = ar

    # range_r: needed by the paper's "j > i" traversal mask (skip subtrees
    # whose max primitive index is below the query's); leaves cover [k, k].
    range_r = torch.cat([last, torch.arange(n, dtype=torch.int32,
                                            device=dev)])

    miss = _compute_ropes(left, right, parent, n_nodes)
    box_lo, box_hi = _fit_boxes(left, right, prim_lo, prim_hi)
    return Tree(left=left, right=right, parent=parent, miss=miss,
                range_r=range_r, box_lo=box_lo, box_hi=box_hi)
