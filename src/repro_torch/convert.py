"""Carry an index across from the reference package.

DBSCAN has no weights: its state is its index. :func:`index_from_numpy`
takes the fields of a reference ``Segments`` and ``Tree`` as numpy arrays
(``{name: np.asarray(getattr(segs, name))}``) and returns this package's
``Segments`` and ``Tree`` on ``device``, so one index can feed both
packages and the walk is compared apart from the build.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.grid import Segments
from .core.lbvh import Tree

# Morton codes are uint32 in the reference and int64 here (the same value).
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.uint32): torch.int64,
           np.dtype(np.bool_): torch.bool}


def _tensor(name: str, arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"index_from_numpy: {name} has dtype {arr.dtype}")
    out = torch.from_numpy(np.ascontiguousarray(arr).astype(
        np.int64 if arr.dtype == np.uint32 else arr.dtype))
    return out.to(device=device, dtype=_DTYPES[arr.dtype])


def index_from_numpy(segs: dict, tree: dict | None, device):
    """(Segments, Tree) on ``device`` from dicts of numpy arrays keyed by
    the reference's field names; ``tree`` may be None (no tree below two
    segments)."""
    s = Segments(**{f: _tensor(f, segs[f], device) for f in Segments._fields})
    if tree is None:
        return s, None
    return s, Tree(**{f: _tensor(f, tree[f], device) for f in Tree._fields})
