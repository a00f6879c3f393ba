"""Core library: the paper's tree-based DBSCAN algorithms in PyTorch.

``dbscan`` is the unified auto-dispatching entry point: it plans a backend
(tree walk or distance tiles) per input and reuses cached indexes across
eps/min_pts sweeps. The per-algorithm implementations stay importable via
``fdbscan`` and ``repro_torch.kernels.ops``.
"""
from .fdbscan import DBSCANResult
from .dispatch import dbscan, plan, Plan
from . import (dispatch, fdbscan, grid, lbvh, morton, traversal, unionfind,
               validate)

__all__ = ["DBSCANResult", "dbscan", "plan", "Plan", "dispatch", "fdbscan",
           "grid", "lbvh", "morton", "traversal", "unionfind", "validate"]
