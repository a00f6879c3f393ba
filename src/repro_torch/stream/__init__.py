"""Streaming DBSCAN subsystem: tiered LSM index of LBVHs, online inserts
and deletes (tombstones + demotion repair), sliding windows, batched
cluster queries, snapshots (DESIGN.md §7, §11), and crash safety —
atomic checkpoints + a write-ahead log with replay recovery
(DESIGN.md §10, ``repro_torch.stream.durability``).

The port of ``repro.stream``, exact to it; on the card every level walk
is the walk kernel. ``StreamingDBSCAN`` is the serving-path handle; the
dispatcher's ``repro_torch.core.dispatch.stream_handle`` builds one that
shares the cached eps-independent batch index. ``StreamingDBSCAN.restore``
rebuilds a handle from a checkpoint + WAL after a crash; the files are the
reference's format, so either package restores the other's.
"""
from . import durability
from .index import (StreamingDBSCAN, QueryResult, MERGE_RATIO, MERGE_MIN,
                    BUFFER_MAX, GROWTH)

__all__ = ["StreamingDBSCAN", "QueryResult", "MERGE_RATIO", "MERGE_MIN",
           "BUFFER_MAX", "GROWTH", "durability"]
