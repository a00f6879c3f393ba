"""Host syncs, counted where the program makes them.

Every host read of a device value on the clustering path, and every
operation there that blocks the host until the device has caught up (an
output whose size depends on the data: ``nonzero``, ``unique``, a
boolean-mask index; a copy from pageable host memory), goes through this
module, so ``host_syncs_total{site=...}`` (:data:`names.HOST_SYNCS`) says
how often a call waits for the device and where.

A site counts wherever its tensors live: on the CPU nothing waits, but the
count is the one the same call makes on the card. With no registry
installed nothing is counted, and neither helper ever adds a read of its
own.
"""
from __future__ import annotations

from . import metrics, names


def read(value, site: str):
    """``value`` (a tensor) on the host: a 0-d tensor as its Python scalar
    (``item()``), any other as a numpy array; counts one sync at
    ``site``."""
    metrics.inc(names.HOST_SYNCS, site=site)
    return value.item() if value.dim() == 0 else value.cpu().numpy()


def blocked(site: str, n: int = 1) -> None:
    """Count ``n`` operations at ``site`` that block the host on the
    device and return a device value (the caller keeps it there)."""
    metrics.inc(names.HOST_SYNCS, float(n), site=site)
