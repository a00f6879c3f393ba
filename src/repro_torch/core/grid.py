"""ε-grid binning and mixed primitives (FDBSCAN-DenseBox, paper §4.2).

The paper superimposes a regular grid with cell edge ``eps/sqrt(d)`` so the
cell diameter is <= eps: every cell holding >= minpts points is *dense* — all
its points are core points of the same cluster, and intra-cell distance
computations are eliminated entirely. Dense cells become box primitives mixed
with the remaining loose points in the *same* BVH.

Every BVH primitive is a *segment*: a contiguous run ``[seg_start, seg_end)``
of the cell-sorted point array. A dense cell is a multi-point segment; every
loose point is a singleton segment. Plain FDBSCAN is the degenerate case
where all segments are singletons in Morton order. One traversal engine
serves both algorithms.

Grid resolution is capped at 2**16 cells/dim (2D) or 2**10 (3D) so cell
coordinates interleave into 32-bit Morton keys. If the cap shrinks cells
below the requested eps/sqrt(d) the dense-cell shortcut would be unsound
(cell diameter could exceed eps), so ``dense_valid`` turns False and the
build degrades to singleton segments (correctness is never affected; only
the optimization is disabled).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.obs import syncs

from . import morton


class Segments(NamedTuple):
    pts: torch.Tensor          # (n, d) f32 points in cell/Morton-sorted order
    order: torch.Tensor        # (n,)  i32 original index of sorted position
    seg_start: torch.Tensor    # (m,)  i32 first member (sorted index)
    seg_end: torch.Tensor      # (m,)  i32 one-past-last member
    seg_of_point: torch.Tensor  # (n,) i32 segment id of each sorted point
    dense_seg: torch.Tensor    # (m,)  bool segment is a dense cell
    dense_pt: torch.Tensor     # (n,)  bool point lies in a dense cell
    codes: torch.Tensor        # (m,)  i64 Morton key per segment (sorted)
    prim_lo: torch.Tensor      # (m, d) f32 tight AABB lower corner
    prim_hi: torch.Tensor      # (m, d) f32 tight AABB upper corner

    @property
    def n_points(self) -> int:
        return self.pts.shape[0]

    @property
    def n_segments(self) -> int:
        return self.seg_start.shape[0]


def singleton_segments(pts_sorted, order, codes_sorted) -> Segments:
    """Singleton-segment index over *already sorted* points."""
    n = pts_sorted.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=pts_sorted.device)
    false = torch.zeros(n, dtype=torch.bool, device=pts_sorted.device)
    return Segments(pts=pts_sorted, order=order, seg_start=idx,
                    seg_end=idx + 1, seg_of_point=idx, dense_seg=false,
                    dense_pt=false, codes=codes_sorted, prim_lo=pts_sorted,
                    prim_hi=pts_sorted)


def build_segments_fdbscan(points: torch.Tensor) -> Segments:
    """Singleton segments in Morton order (plain FDBSCAN index)."""
    pts, order, codes = morton.morton_sort(points)
    return singleton_segments(pts, order, codes)


def _cell_coords(points: torch.Tensor, eps: float):
    """Integer (int64) cell coordinates on the eps/sqrt(d) grid, plus the
    validity flag (False when the resolution cap shrank the cells)."""
    n, d = points.shape
    bits = morton.BITS_2D if d == 2 else morton.BITS_3D
    cell = eps / math.sqrt(d)
    lo = points.amin(0)
    hi = points.amax(0)
    extent = torch.clamp_min(hi - lo, torch.finfo(points.dtype).tiny)
    ncell = torch.ceil(extent / morton.f32(cell, points))
    over = ncell > 2**bits
    capped = syncs.read(over.any(), "grid.cell_coords")
    scale = torch.where(over, morton.f32(2.0**bits, points) / extent,
                        morton.f32(1.0 / cell, points))
    c = torch.floor((points - lo) * scale).to(torch.int32)
    c = torch.clamp(c, 0, 2**bits - 1)
    return c.to(torch.int64), not capped


def _cell_morton(cells: torch.Tensor) -> torch.Tensor:
    d = cells.shape[1]
    if d == 2:
        return ((morton._expand_bits_2d(cells[:, 0]) << 1)
                | morton._expand_bits_2d(cells[:, 1]))
    return ((morton._expand_bits_3d(cells[:, 0]) << 2)
            | (morton._expand_bits_3d(cells[:, 1]) << 1)
            | morton._expand_bits_3d(cells[:, 2]))


def _segment_reduce(src: torch.Tensor, seg: torch.Tensor, m: int,
                    reduce: str) -> torch.Tensor:
    """``jax.ops.segment_min/max/sum`` over ``m`` segments (every segment
    here is non-empty, so ``include_self=False`` leaves no fill value)."""
    index = seg.long()
    if src.dim() == 2:
        index = index[:, None].expand_as(src)
    out = torch.empty((m,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    return out.scatter_reduce_(0, index, src, reduce, include_self=False)


def build_segments_densebox(points: torch.Tensor, eps: float,
                           min_pts: int) -> Segments:
    """Mixed dense-cell / loose-point segments (FDBSCAN-DenseBox index).

    The segment count ``m`` is data dependent, so the build reads it back
    to the host once (two scalar reads).
    """
    n, d = points.shape
    if d not in (2, 3) or eps <= 0:
        # degenerate eps: no grid to build — singleton segments are always
        # correct, only the dense-cell optimization is lost
        return build_segments_fdbscan(points)
    dev = points.device
    cells, dense_valid = _cell_coords(points, eps)
    codes_pt = _cell_morton(cells)
    order = torch.argsort(codes_pt, stable=True)
    pts = points[order]
    codes_sorted = codes_pt[order]

    new_cell = torch.ones(n, dtype=torch.bool, device=dev)
    new_cell[1:] = codes_sorted[1:] != codes_sorted[:-1]
    cell_rank = torch.cumsum(new_cell, 0) - 1   # dense cell rank per point
    n_cells = syncs.read(cell_rank[-1], "grid.densebox") + 1
    counts = _segment_reduce(torch.ones(n, dtype=torch.int32, device=dev),
                             cell_rank, n_cells, "sum")
    dense_pt = (counts[cell_rank] >= min_pts) & dense_valid

    # Segment boundaries: first member of a dense cell, or any loose point.
    is_new_seg = new_cell | ~dense_pt
    seg_of_point = (torch.cumsum(is_new_seg, 0) - 1).to(torch.int32)
    m = syncs.read(seg_of_point[-1], "grid.densebox") + 1

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    seg_start = _segment_reduce(idx, seg_of_point, m, "amin")
    seg_end = _segment_reduce(idx, seg_of_point, m, "amax") + 1
    dense_seg = _segment_reduce(dense_pt.to(torch.int32), seg_of_point, m,
                                "amax").to(torch.bool)
    prim_lo = _segment_reduce(pts, seg_of_point, m, "amin")
    prim_hi = _segment_reduce(pts, seg_of_point, m, "amax")
    seg_codes = codes_sorted[seg_start]
    return Segments(pts=pts, order=order.to(torch.int32),
                    seg_start=seg_start, seg_end=seg_end,
                    seg_of_point=seg_of_point, dense_seg=dense_seg,
                    dense_pt=dense_pt, codes=seg_codes,
                    prim_lo=prim_lo, prim_hi=prim_hi)
