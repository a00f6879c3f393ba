"""Core library: the paper's tree-based DBSCAN algorithms in PyTorch.

``dbscan`` is the unified auto-dispatching entry point: it plans a backend
(tree walk or distance tiles) per input and reuses cached indexes across
eps/min_pts sweeps. The per-algorithm implementations stay importable via
``fdbscan`` and ``repro_torch.kernels.ops``; ``neighbors`` holds the
radius and k-nearest-neighbor queries over the same cached index, and
``stream_handle`` builds a streaming handle (``repro_torch.stream``) over
it.
"""
from .fdbscan import DBSCANResult
from .dispatch import dbscan, plan, Plan, stream_handle
from . import (dispatch, fdbscan, grid, lbvh, morton, neighbors, traversal,
               unionfind, validate)

__all__ = ["DBSCANResult", "dbscan", "plan", "Plan", "stream_handle",
           "dispatch", "fdbscan", "grid", "lbvh", "morton", "neighbors",
           "traversal", "unionfind", "validate"]
