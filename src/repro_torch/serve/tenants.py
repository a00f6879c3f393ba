"""Multi-tenant views over one shared point stream (DESIGN.md §13).

The port of ``repro.serve.tenants``. Every tenant's handle and snapshots
live on one device: the current CUDA device unless the caller passes
``device="cpu"``.

A tenant is an independent ``(eps, min_pts)`` *view* of the same data:
the anomaly team wants tight clusters at eps=0.01, the heat-map wants
coarse ones at eps=0.05, and neither should pay for — or be able to
break — the other.  The eps-independent part of the work (the Morton
sort + LBVH of the point set) is shared through ``dispatch.plan``'s
index cache: :func:`repro_torch.core.dispatch.tenant_handles` builds every
tenant's streaming handle off **one** cached index build.  Everything
eps-dependent is private per tenant:

  * its own ``StreamingDBSCAN`` handle (labels, counts, core mask —
    these depend on eps/min_pts and cannot be shared);
  * its own :class:`~repro_torch.serve.snapshot.SnapshotStore` with its own
    monotonic version counter — tenants publish independently, and a
    failed rebuild for one tenant leaves every other tenant's serving
    view untouched;
  * its own label namespace: ``QueryResult.labels`` are component
    representatives in the tenant's own clustering, never comparable
    across tenants;
  * its own durability files (``<dir>/<name>.wal`` / ``<name>.npz``)
    and its own per-tenant metric series (``tenant=<name>`` labels).
"""
from __future__ import annotations

import os
import re
from typing import NamedTuple

from repro_torch.core import dispatch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.serve import snapshot as snapshot_mod
from repro_torch.stream import StreamingDBSCAN

_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


class TenantSpec(NamedTuple):
    """Declarative tenant description: a name plus its view parameters."""
    name: str
    eps: float
    min_pts: int


def check_specs(specs) -> list[TenantSpec]:
    """Validate and normalize a tenant spec list (names unique and
    path-safe — they become WAL/checkpoint file stems)."""
    out = [TenantSpec(str(s[0]), float(s[1]), int(s[2])) for s in specs]
    if not out:
        raise ValueError("a server needs at least one tenant")
    seen = set()
    for s in out:
        if not _NAME_RE.match(s.name):
            raise ValueError(f"tenant name {s.name!r} must match "
                             f"{_NAME_RE.pattern} (it names durability "
                             "files and metric labels)")
        if s.name in seen:
            raise ValueError(f"duplicate tenant name {s.name!r}")
        seen.add(s.name)
        if s.eps <= 0:
            raise ValueError(f"tenant {s.name!r}: eps must be > 0")
        if s.min_pts < 1:
            raise ValueError(f"tenant {s.name!r}: min_pts must be >= 1")
    return out


def durability_paths(durability_dir: str | None, name: str):
    """(wal_path, checkpoint_path) for one tenant; (None, None) when
    durability is off."""
    if durability_dir is None:
        return None, None
    return (os.path.join(durability_dir, f"{name}.wal"),
            os.path.join(durability_dir, f"{name}.npz"))


class TenantView:
    """One tenant's serving state: handle + snapshot store + batcher slot.

    The view owns the tenant's version counter: :meth:`publish` freezes
    the handle into the next version and atomically swaps it in.  The
    freeze runs *off* the query path (the writer thread); queries only
    ever touch ``store.current()``.
    """

    def __init__(self, spec: TenantSpec, handle, *, keep_versions: int = 1):
        self.spec = spec
        self.name = spec.name
        self.handle = handle
        self.store = snapshot_mod.SnapshotStore(keep=keep_versions)
        self.publish()                      # v1: serving starts consistent

    def publish(self) -> "snapshot_mod.IndexSnapshot":
        """Freeze the handle's current state and swap it in as the next
        snapshot version.  Any exception during the freeze propagates
        *before* the swap — the old version keeps serving."""
        snap = snapshot_mod.freeze(self.handle,
                                   version=self.store.version + 1)
        self.store.publish(snap)
        obs_metrics.inc(obs_names.SERVE_SNAPSHOT_PUBLISHES,
                        tenant=self.name)
        obs_metrics.set_gauge(obs_names.SERVE_SNAPSHOT_VERSION,
                              float(snap.version), tenant=self.name)
        obs_metrics.set_gauge(obs_names.SERVE_TENANT_ACTIVE_POINTS,
                              float(snap.n_points), tenant=self.name)
        return snap

    def stats(self) -> dict:
        snap = self.store.current()
        return {
            "name": self.name, "eps": self.spec.eps,
            "min_pts": self.spec.min_pts,
            "version": self.store.version,
            "n_active": int(self.handle.n_active),
            "watermark": int(self.handle.n_points),
            "snapshot": snap.stats() if snap is not None else None,
        }


def build_views(points, specs, *, durability_dir: str | None = None,
                window: int | None = None, checkpoint_every: int = 0,
                keep_versions: int = 1, device=None,
                **handle_kwargs) -> list[TenantView]:
    """Build every tenant's view over one shared index build.

    Routes through :func:`repro_torch.core.dispatch.tenant_handles`, so N
    tenants over the same points cost one Morton sort + one LBVH build
    (the ``dispatch_index_builds_total`` counter proves it), then wraps
    each handle in a :class:`TenantView` with its published v1 snapshot.
    ``device``: where every handle and snapshot lives (default the
    current CUDA device; ``RuntimeError`` without one).
    """
    specs = check_specs(specs)
    device = dispatch.resolve_device(device)
    if durability_dir is not None:
        os.makedirs(durability_dir, exist_ok=True)
    tenants = {}
    for s in specs:
        wal, ckpt = durability_paths(durability_dir, s.name)
        tenants[s.name] = dict(eps=s.eps, min_pts=s.min_pts, wal=wal,
                               checkpoint_path=ckpt, window=window,
                               checkpoint_every=checkpoint_every,
                               **handle_kwargs)
    handles = dispatch.tenant_handles(points, tenants, device=device)
    return [TenantView(s, handles[s.name], keep_versions=keep_versions)
            for s in specs]


def restore_views(specs, *, durability_dir: str,
                  window: int | None = None, checkpoint_every: int = 0,
                  keep_versions: int = 1, topup_batch: int = 512,
                  device=None, **handle_kwargs) -> list[TenantView]:
    """Recover every tenant's view from its durability files after a
    crash, then *top up* lagging tenants.

    Each tenant recovers independently (checkpoint + WAL replay,
    ``StreamingDBSCAN.restore``) onto ``device`` (default the current CUDA
    device).  Because the writer applies one insert batch to the tenants in
    sequence, a crash mid-apply can leave replicas at different
    watermarks; the leader (highest watermark) holds the authoritative
    point stream, so every lagging tenant replays the leader's missing
    suffix through its normal ``insert`` path (re-logged to its own WAL —
    the top-up itself is durable).  After restore all tenants sit at the
    same watermark and serving resumes from freshly published snapshots.
    """
    specs = check_specs(specs)
    device = dispatch.resolve_device(device)
    handles = {}
    for s in specs:
        wal, ckpt = durability_paths(durability_dir, s.name)
        handles[s.name] = StreamingDBSCAN.restore(
            ckpt, wal=wal, window=window, device=device,
            checkpoint_every=checkpoint_every, **handle_kwargs)
        if (abs(handles[s.name].eps - s.eps) > 1e-12
                or handles[s.name].min_pts != s.min_pts):
            raise ValueError(
                f"tenant {s.name!r}: durable state has eps="
                f"{handles[s.name].eps}/min_pts={handles[s.name].min_pts}, "
                f"spec says eps={s.eps}/min_pts={s.min_pts}")
    leader = max(handles.values(), key=lambda h: h.n_points)
    for s in specs:
        h = handles[s.name]
        while h.n_points < leader.n_points:
            lo = h.n_points
            hi = min(lo + int(topup_batch), leader.n_points)
            h.insert(leader.stream_slice(lo, hi))
    return [TenantView(s, handles[s.name], keep_versions=keep_versions)
            for s in specs]
