"""Bulk-synchronous union-find (the ECL-CC union-find without atomics).

The paper uses Jaiganesh & Burtscher's synchronization-free GPU union-find
with *intermediate pointer jumping*. The same disjoint-set semantics come
from deterministic bulk primitives:

  * HOOK:  labels <- min(labels, candidate)  (elementwise),
  * JUMP:  labels <- labels[labels]          (one gather doubles every path
           compression step — the bulk analogue of pointer jumping),

iterated to a fixpoint. ``labels[i]`` always holds the index of some point
known to be in i's cluster, is monotonically non-increasing, and converges
to the minimum member index of the connected component (the canonical
representative). The paper's finalization (make every label point at the
root) is ``jump_to_fixpoint``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs import syncs


def jump_once(labels: torch.Tensor) -> torch.Tensor:
    return labels[labels]


def jump_to_fixpoint_np(labels: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`jump_to_fixpoint` for host-driven repair
    loops. Requires ``labels[i] <= i`` — a decreasing pointer forest — so
    the doubling can never cycle."""
    while True:
        jumped = labels[labels]
        if (jumped == labels).all():
            return labels
        labels = jumped


def jump_to_fixpoint(labels: torch.Tensor) -> torch.Tensor:
    """Full path compression: every label points at its root. The host
    reads one flag a jump."""
    while True:
        jumped = labels[labels]
        if syncs.read((jumped == labels).all(), "unionfind.jump"):
            return labels
        labels = jumped


def hook(labels: torch.Tensor, candidate: torch.Tensor,
         mask=None) -> torch.Tensor:
    """labels <- min(labels, candidate) where mask (monotone hook)."""
    new = torch.minimum(labels, candidate)
    if mask is not None:
        new = torch.where(mask, new, labels)
    return new
