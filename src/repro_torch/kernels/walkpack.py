"""The walk kernel's packed, read-only index layout.

:func:`pack_index` turns an index (``Tree`` + ``Segments``) into the layout
``csrc/walk.cu`` reads, with plain torch ops on the index's device. It is
built once per index and cached with it (``dispatch.Plan.walk_index``), so
its cost is part of the index build, not of each walk.

Layout (int32 words; floats are stored as their bits):

* ``nodes`` (2m-1, 8): one 32-byte record per node, read as two 16-byte
  loads. Words ``0 .. 2d-1`` hold the box, lower corner then upper corner;
  word 6 the rope (``miss``); word 7 the left child of an internal node, or
  the first member (``seg_start``) of a leaf. A leaf of one member whose
  box corners are both that member's point, bit for bit, holds
  ``~seg_start`` (negative) instead: its member test's squared distance is
  the box distance, so the kernel takes the test from the node step and
  loads no point. For d = 2, word 4 of a leaf holds ``leaf_end`` as well,
  so a 2-D node step needs the record alone; the other words are 0.
* ``leaf_end`` (m,): a leaf's member end (``seg_end``), with its dense flag
  in bit 31.
* ``pts`` (n, 4) float32 for d = 3 (the fourth lane 0, never summed) or
  (n, 2) for d = 2: one vector load per member.

A minlabel walk's values and gather masks change every sweep; the kernel
reads them as they are, and only for the members within eps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.grid import Segments
from repro_torch.core.lbvh import Tree

#: words of a node record
RECORD_WORDS = 8
MISS_WORD, LINK_WORD, LEAF_END_WORD_2D = 6, 7, 4
DENSE_BIT = -2**31          # bit 31 of an int32


class WalkIndex(NamedTuple):
    """The packed index of one (Tree, Segments) pair (see module doc)."""
    nodes: torch.Tensor      # (2m-1, 8) int32
    leaf_end: torch.Tensor   # (m,) int32
    pts: torch.Tensor        # (n, 4) or (n, 2) float32

    @property
    def d(self) -> int:
        return 3 if self.pts.shape[1] == 4 else 2

    @property
    def n_segments(self) -> int:
        return self.leaf_end.shape[0]


def pack_index(tree: Tree, segs: Segments) -> WalkIndex:
    """The walk kernel's layout of ``tree``/``segs``, on their device.

    Needs d in {2, 3} and at least two segments (a tree)."""
    n, d = segs.pts.shape
    m = segs.n_segments
    if d not in (2, 3):
        raise ValueError(f"pack_index: d must be 2 or 3, got {d}")
    if tree is None or m < 2:
        raise ValueError("pack_index: the index needs a tree (at least two "
                         "segments)")
    pack_index.builds += 1
    dev = segs.pts.device
    i32 = torch.int32
    leaf_end = torch.where(segs.dense_seg, segs.seg_end | DENSE_BIT,
                           segs.seg_end).to(i32)
    nodes = torch.zeros(2 * m - 1, RECORD_WORDS, dtype=i32, device=dev)
    nodes[:, :d] = tree.box_lo.contiguous().view(i32)
    nodes[:, d:2 * d] = tree.box_hi.contiguous().view(i32)
    nodes[:, MISS_WORD] = tree.miss
    nodes[:m - 1, LINK_WORD] = tree.left
    first = segs.seg_start.clamp(0, max(n - 1, 0)).long()
    member = segs.pts[first].contiguous().view(i32)
    single = ((segs.seg_end - segs.seg_start == 1)
              & (tree.box_lo[m - 1:].contiguous().view(i32) == member).all(1)
              & (tree.box_hi[m - 1:].contiguous().view(i32) == member).all(1))
    nodes[m - 1:, LINK_WORD] = torch.where(single, ~segs.seg_start,
                                           segs.seg_start)
    if d == 2:
        nodes[m - 1:, LEAF_END_WORD_2D] = leaf_end
    pts = segs.pts.to(torch.float32)
    if d == 3:
        pts = torch.cat([pts, torch.zeros(n, 1, dtype=torch.float32,
                                          device=dev)], dim=1)
    return WalkIndex(nodes=nodes, leaf_end=leaf_end, pts=pts.contiguous())


# Layouts built (a plain integer, read by the on-card smoke run to show
# that clustering with a plan builds none).
pack_index.builds = 0

