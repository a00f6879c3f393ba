"""repro_torch.serve — the serving subsystem (DESIGN.md §13), the port of
``repro.serve``.

Turns the streaming index into a long-lived multi-tenant service:

  * :mod:`repro_torch.serve.batching` — continuous adaptive
    micro-batching on the shared bucket ladder;
  * :mod:`repro_torch.serve.snapshot` — immutable versioned index
    snapshots with atomic swap (queries never block behind writes),
    answered on the snapshot's device;
  * :mod:`repro_torch.serve.tenants` — per-(eps, min_pts) views sharing
    one cached index build;
  * :mod:`repro_torch.serve.admission` — bounded queues, typed load
    shedding, latency SLO sketches;
  * :mod:`repro_torch.serve.server` — the :class:`Server` tying the
    planes together, with graceful shutdown and crash recovery.

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``. ``python -m repro_torch.launch.serve`` is the CLI.
"""
from repro_torch.serve.admission import AdmissionController, Overloaded
from repro_torch.serve.batching import MicroBatcher, bucket_size
from repro_torch.serve.server import (InsertReply, QueryReply, Server,
                                      ServerConfig)
from repro_torch.serve.snapshot import (FrozenState, IndexSnapshot,
                                        SnapshotStore, freeze)
from repro_torch.serve.tenants import TenantSpec, TenantView, build_views, \
    restore_views

__all__ = [
    "Server", "ServerConfig", "QueryReply", "InsertReply",
    "TenantSpec", "TenantView", "build_views", "restore_views",
    "IndexSnapshot", "SnapshotStore", "FrozenState", "freeze",
    "AdmissionController", "Overloaded",
    "MicroBatcher", "bucket_size",
]
