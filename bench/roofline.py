"""The least time an H100 could take for a clustering, from its inputs.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): float32 outside the tensor cores 67
TFLOP/s, HBM3 3.35 TB/s. A card may be set below 700 W; the benchmark
prints the card's ``power.limit`` beside every share of a peak.

The work is counted from the inputs and the reference's own counts, never
from the program's: a program that does less work cannot lower its bound.

* Bytes: the points read once (``n * d`` float32) and the outputs written
  once (labels int32, core mask one byte a point).
* Operations: the distance tests an exact run on the reference's grid
  makes to settle every core status. A point in a small cell (side
  ``eps / sqrt(d)``) holding ``min_pts`` points or more is core by geometry
  and needs none; every other point sees its neighbours up to
  ``min_pts - 1`` of them (itself excluded). A test is ``3 d`` operations:
  ``d`` differences, ``d`` products, ``d - 1`` sums and a comparison. A run
  on another grid could skip more, so this term is no proven floor; the
  byte term is one.
"""
from __future__ import annotations

PEAK_FLOPS_FP32 = 67e12     # operations/s
HBM_BYTES_PER_S = 3.35e12   # bytes/s


def terms(ops: float, nbytes: float) -> dict:
    """Both terms of the bound, the bound, and which term sets it."""
    t_ops = ops / PEAK_FLOPS_FP32
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "t_ops_s": t_ops,
            "t_bytes_s": t_bytes, "bound_s": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}


def clustering_work(n: int, d: int, count_strict, dense) -> tuple:
    """(operations, bytes) of one exact clustering of ``n`` points in ``d``
    dimensions. ``count_strict`` is the reference's neighbour count
    (itself included, saturated at ``min_pts``) and ``dense`` its small-cell
    mask, as ``reference.dbscan_ref.core_counts`` gives them."""
    tests = float((count_strict[~dense] - 1).clamp_min(0).sum())
    return 3 * d * tests, n * d * 4 + n * 4 + n


def share(bound_s: float, measured_s: float) -> float | None:
    """The bound as a percentage of the measured time (None without a
    measured time)."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
